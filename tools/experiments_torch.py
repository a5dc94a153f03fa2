"""What the port's evaluation tools share (`run_ablation_sweep_torch.py`,
`run_sim_sensitivity_torch.py`, `run_time_continuous_ab_torch.py`): the
device a run is made on, and the merge of the CSV parts that runs split
by grid or seed write.

The tools run on the CUDA card unless given `--cpu`; with neither a card
nor `--cpu` they raise before any work, so no number of a CPU run is ever
written under a card's name.
"""

import csv
import subprocess


def device_label(cpu: bool) -> str:
    """"cpu" when the caller asked for the CPU; else the card's name and
    power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (the name alone where nvidia-smi
    cannot be read). Raises RuntimeError without a card."""
    if cpu:
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --cpu to run on the CPU")
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


def read_rows(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def write_rows(path: str, rows: list, fieldnames: list) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)


def merge_parts(parts: list, out: str, key=None) -> int:
    """Concatenate the rows of the CSV `parts` into `out`, under the first
    part's columns (every part must have them, and no other); with `key`,
    a row replaces an earlier part's row of the same key (a job run again),
    and the rows are sorted by it. Returns the row count."""
    rows, fields = [], None
    for path in parts:
        with open(path, newline="") as f:
            r = csv.DictReader(f)
            if fields is None:
                fields = list(r.fieldnames)
            elif set(r.fieldnames) != set(fields):
                raise ValueError(f"{path}: columns differ from {parts[0]}'s")
            rows += list(r)
    if key is not None:
        rows = sorted({key(r): r for r in rows}.values(), key=key)
    write_rows(out, rows, fields)
    return len(rows)
