"""Parameter-sweep harness: the reference's evaluation "fleet", rebuilt.

The reference sweeps ablations with bash workers — a 17-deep cartesian loop
assigning `offline_odometry` processes to NR_WORKERS shells
(`launch/oxford/eval/utils/{start_workers,worker,execute_sequence}`) and a
`merge_eval.py` that joins `pars.txt` + `est/result.txt` into one CSV.

Here a sweep is an explicit cartesian product over config overrides, executed
in-process (each job reuses the jit cache when shapes match) or fanned out to
worker processes; results land in `job_N/` directories and `merge()` joins
them into one CSV, column-per-parameter, like the reference's merger.

The canonical ablation grids (1_baseline_eval ... 10_baseline_p2d_eval) are
encoded in `ABLATIONS`.
"""

from __future__ import annotations

import csv
import itertools
import os
from typing import Dict, List, Sequence


# reference ablation grids (`launch/oxford/eval/*`, SURVEY.md §4)
ABLATIONS: Dict[str, Dict[str, Sequence]] = {
    "baseline": {},
    "weight_intensity": {"weight_intensity": ["true", "false"]},
    "residual_weight": {"weight_option": ["Uniform", "Sim_N", "Sim_direction",
                                          "Sim_scale", "Combined"]},
    "filter": {"k_strongest": [12, 15, 20, 40], "z_min": [60, 70, 80]},
    "resolution": {"res": [1.5, 2.0, 2.5, 3.0, 3.5]},
    "submap_keyframes": {"submap_scan_size": [1, 2, 3, 4, 8]},
    "motion_compensation": {"compensate": ["true", "false"]},
    "loss_function": {"loss_type": ["None", "Huber", "Cauchy", "Tukey"],
                      "loss_limit": [0.1, 1.0]},
    "baseline_p2d": {"cost_type": ["P2D"],
                     "covar_scale": [1.0, 2.0, 5.0]},
}


def expand_grid(grid: Dict[str, Sequence]) -> List[Dict[str, object]]:
    if not grid:
        return [{}]
    keys = list(grid)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(grid[k] for k in keys))]


def run_sweep(output_root: str, grid: Dict[str, Sequence],
              base_args: List[str], n_workers: int = 1,
              worker_index: int = 0) -> List[str]:
    """Run every job whose index % n_workers == worker_index (the reference's
    `job_nr % NR_WORKERS` assignment). Returns the job directories."""
    from cfear_radarodometry_code_public_tpu_torch import offline_odometry

    jobs = expand_grid(grid)
    dirs = []
    for job_nr, overrides in enumerate(jobs):
        job_dir = os.path.join(output_root, f"job_{job_nr}")
        dirs.append(job_dir)
        if job_nr % n_workers != worker_index:
            continue
        argv = list(base_args) + ["--output-dir", job_dir]
        for k, v in overrides.items():
            argv += [f"--{k}", str(v)]
        offline_odometry.main(argv)
    return dirs


def merge(output_root: str, csv_path: str) -> int:
    """Join every job's pars.txt + est/result.txt into one CSV
    (merge_eval.py equivalent, `launch/oxford/eval/merge_eval.py:15-73`).
    Walks nested roots, so multi-grid / multi-seed sweeps merge in one
    pass; the `job` column is the directory path relative to the root."""
    jobs = []
    for dirpath, dirnames, filenames in os.walk(output_root):
        if os.path.basename(dirpath).startswith("job_") \
                and "pars.txt" in filenames:
            jobs.append(dirpath)
    rows = []
    for job_dir in sorted(jobs):
        pars = os.path.join(job_dir, "pars.txt")
        row = {"job": os.path.relpath(job_dir, output_root)}
        with open(pars) as f:
            for line in f:
                if ", " in line:
                    k, v = line.strip().split(", ", 1)
                    row[k] = v
        result = os.path.join(job_dir, "est", "result.txt")
        if os.path.exists(result):
            with open(result) as f:
                for line in f:
                    if ": " in line:
                        k, v = line.strip().split(": ", 1)
                        row[k] = v
        rows.append(row)
    if not rows:
        return 0
    keys = sorted({k for r in rows for k in r})
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    return len(rows)
