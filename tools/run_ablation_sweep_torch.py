"""The reference's ablation sweep, run by the PyTorch/CUDA port.

The port's counterpart of `tools/run_ablation_sweep.py` (which stays the
reference's tool), with its arguments and defaults: the nine grids of
`parallel/sweep.py:ABLATIONS` over several seeds of the adversarial
synthetic world (40 moving objects, azimuth dropout p=0.5, interference
bursts p=0.4, 12 m/s, max_cells 1024), each job one in-process call of the
port's `offline_odometry.main` through the port's `parallel.sweep.run_sweep`,
merged into one CSV by `sweep.merge`. The CSV has the reference CSV's
columns and a `device` column: the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
them, or "cpu". `tests/test_ablation_trends.py`'s assertions read it
unchanged (`tests/test_torch_trends.py`).

Runs on the card; `--cpu` asks for the CPU, and without a card and without
`--cpu` it raises. The committed artifact
`eval_results/ablation_sweep_torch_h100.csv` has the reference artifact's
parameters (seeds 11 and 12, 120 frames), made in parts on the card and
merged:

    python tools/run_ablation_sweep_torch.py --seeds 11 --n-frames 120 \\
        --output-root run/sweep --csv run/ablation_11.csv
    python tools/run_ablation_sweep_torch.py --seeds 12 --n-frames 120 \\
        --output-root run/sweep --csv run/ablation_12.csv
    python tools/run_ablation_sweep_torch.py \\
        --merge run/ablation_11.csv,run/ablation_12.csv \\
        --csv eval_results/ablation_sweep_torch_h100.csv

`--grids` and `--n-workers`/`--worker-index` cut a part further. A job's
frames/s (the `fps` column) is the host clock's, over the runner's
`process` and `trajectory` calls.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import experiments_torch  # noqa: E402


def main(argv=None):
    from cfear_radarodometry_code_public_tpu_torch.parallel import sweep

    ap = argparse.ArgumentParser()
    ap.add_argument("--output-root",
                    default=os.path.join(tempfile.gettempdir(),
                                         "cfear_sweep_torch"))
    ap.add_argument("--csv", default="eval_results/ablation_sweep_torch_h100.csv")
    ap.add_argument("--grids", default=",".join(sweep.ABLATIONS))
    ap.add_argument("--seeds", default="11,12,13")
    ap.add_argument("--n-frames", type=int, default=150)
    ap.add_argument("--speed", type=float, default=12.0)
    ap.add_argument("--max-cells", type=int, default=1024,
                    help="cell budget for sweep jobs (1024: the calibrated "
                         "trend regime)")
    ap.add_argument("--n-workers", type=int, default=1)
    ap.add_argument("--worker-index", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain twins)")
    ap.add_argument("--merge", default=None, metavar="CSV,CSV,...",
                    help="merge these part CSVs into --csv and run nothing")
    args = ap.parse_args(argv)

    if args.merge:
        n = experiments_torch.merge_parts(args.merge.split(","), args.csv,
                                          key=lambda r: r["job"])
        print(f"[sweep] merged {n} rows -> {args.csv}", flush=True)
        return n

    device = experiments_torch.device_label(args.cpu)
    base = ["--dataset", "synthetic",
            "--n-frames", str(args.n_frames),
            "--speed", str(args.speed),
            "--n-dynamic", "40", "--dropout-prob", "0.5",
            "--speckle-burst-prob", "0.4",
            "--max_cells", str(args.max_cells),
            "--chunk", "25", "--no-save-graph"] + (["--cpu"] if args.cpu
                                                   else [])
    t0 = time.time()
    n_jobs = 0
    for grid_name in args.grids.split(","):
        grid = sweep.ABLATIONS[grid_name]
        for seed in args.seeds.split(","):
            root = os.path.join(args.output_root, grid_name, f"seed_{seed}")
            print(f"[sweep] grid={grid_name} seed={seed} "
                  f"({len(sweep.expand_grid(grid))} jobs, "
                  f"{time.time() - t0:.0f}s elapsed)", flush=True)
            sweep.run_sweep(root, grid, base + ["--seed", seed],
                            n_workers=args.n_workers,
                            worker_index=args.worker_index)
            n_jobs += len(sweep.expand_grid(grid))
    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
    n = sweep.merge(args.output_root, args.csv)
    if not n:
        raise RuntimeError(f"no job under {args.output_root} wrote pars.txt")
    rows = experiments_torch.read_rows(args.csv)
    for r in rows:
        r["device"] = device
    experiments_torch.write_rows(args.csv, rows, sorted(rows[0]))
    print(f"[sweep] merged {n} rows -> {args.csv} "
          f"({n_jobs} jobs, {time.time() - t0:.0f}s, {device})", flush=True)
    return n


if __name__ == "__main__":
    main()
