"""The reference's time-continuous registration A/B, run by the
PyTorch/CUDA port.

The port's counterpart of `tools/run_time_continuous_ab.py` (which stays
the reference's tool), with its arguments and defaults: one synthetic
sequence (CFEAR-3, max_cells 1024) through `models/odometry.OdometryRunner`
(chunk 16) with `registration.time_continuous` off and on, one row a mode
with KITTI-protocol drift and ATE, in the reference artifact's layout. Its
header line names the device in place of the reference's `backend=`: the
card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them, or "cpu".

Runs on the card; `--cpu` asks for the CPU, and without a card and without
`--cpu` it raises:

    python tools/run_time_continuous_ab_torch.py \\
        --out run/TIME_CONTINUOUS_AB_torch_h100.txt   # the card
    python tools/run_time_continuous_ab_torch.py --cpu --n-frames 16 \\
        --out run/tc.txt                                       # the CPU
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import experiments_torch  # noqa: E402


def main(argv=None):
    import numpy as np
    from cfear_radarodometry_code_public_tpu_torch.config import preset
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    from cfear_radarodometry_code_public_tpu_torch.eval.kitti import kitti_drift
    from cfear_radarodometry_code_public_tpu_torch.eval.trajectory import (
        ate_rmse)
    from cfear_radarodometry_code_public_tpu_torch.models import odometry

    ap = argparse.ArgumentParser()
    ap.add_argument("--n-frames", type=int, default=256)
    ap.add_argument("--speed", type=float, default=12.0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--max-cells", type=int, default=1024)
    ap.add_argument("--out",
                    default="eval_results/TIME_CONTINUOUS_AB_torch_h100.txt")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain twins)")
    args = ap.parse_args(argv)
    device_label = experiments_torch.device_label(args.cpu)
    device = "cpu" if args.cpu else "cuda"

    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=args.max_cells))
    images, gt = synthetic.make_sequence(seed=args.seed,
                                         n_frames=args.n_frames, cfg=cfg,
                                         speed=args.speed)
    path_len = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0),
                                           axis=1)))
    lengths = tuple(L for L in (50.0, 100.0, 200.0, 300.0, 400.0)
                    if L < 0.6 * path_len)

    rows = []
    for tc in (False, True):
        c = cfg.replace(registration=dataclasses.replace(
            cfg.registration, time_continuous=tc))
        runner = odometry.OdometryRunner(c, chunk=16, device=device)
        t0 = time.time()
        runner.process(images)
        traj = np.asarray(runner.trajectory())
        wall = time.time() - t0
        drift = kitti_drift(traj, np.asarray(gt), lengths=lengths)
        ate = float(ate_rmse(traj[:, :2], gt[:, :2]))
        ok = bool(runner.frame_outputs().success.all())
        rows.append((tc, drift["t_err_percent"], drift["r_err_deg_per_m"],
                     ate, ok, wall))
        print(f"time_continuous={tc}: t_err={drift['t_err_percent']:.3f}% "
              f"r_err={drift['r_err_deg_per_m']:.4f} deg/m ATE={ate:.3f} m "
              f"success={ok} wall={wall:.1f}s (host clock, "
              f"{len(images) / wall:.2f} frames/s)", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(
            "time-continuous registration A/B "
            "(`RegisterTimeContinuous`, n_scan_normal.cpp:67-80)\n"
            f"synthetic seed={args.seed} n_frames={args.n_frames} "
            f"speed={args.speed} m/s path={path_len:.0f} m "
            f"max_cells={args.max_cells} device={device_label} "
            f"subseq lengths={[int(L) for L in lengths]} m\n"
            "mode              t_err%   r_err(deg/m)  ATE(m)  all_success\n")
        for tc, t_err, r_err, ate, ok, wall in rows:
            f.write(f"tc={'on ' if tc else 'off'}            "
                    f"{t_err:7.3f}  {r_err:11.4f}  {ate:6.3f}  {ok}\n")
        f.write("(reference keeps the variant off by default — "
                "'doesn't improve results', n_scan_normal.cpp:227; "
                "motion compensation already de-skews the cloud before "
                "feature extraction, so the residual warp is sub-cm at "
                "these speeds)\n")
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
