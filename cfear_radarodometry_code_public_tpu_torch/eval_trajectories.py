"""Trajectory evaluation CLI — the `eval_node` / external kitti-eval
equivalent: score an estimated trajectory against ground truth.

Port of the reference's `eval_trajectories.py` (numpy only). Reads
KITTI-format files (or an offline_odometry output directory), computes
KITTI drift + ATE, writes result.txt and an optional trajectory plot.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--est", required=True,
                    help="est KITTI file or run directory")
    ap.add_argument("--gt", default=None, help="gt KITTI file")
    ap.add_argument("--align", default="none", choices=["none", "se2"])
    ap.add_argument("--plot", default=None)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)

    from cfear_radarodometry_code_public_tpu_torch.eval import kitti, trajectory, viz
    from cfear_radarodometry_code_public_tpu_torch.utils import se2

    est_path, gt_path = args.est, args.gt
    if os.path.isdir(args.est):
        seq = sorted(f for f in os.listdir(os.path.join(args.est, "est"))
                     if f.endswith(".txt") and "_" not in f)[0]
        est_path = os.path.join(args.est, "est", seq)
        gt_path = gt_path or os.path.join(args.est, "gt", seq)

    est = se2.from_matrix(trajectory.read_kitti(est_path))
    gt = se2.from_matrix(trajectory.read_kitti(gt_path))
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]

    if args.align == "se2":
        R, t, _ = trajectory.umeyama_align(est[:, :2], gt[:, :2])
        est_xy = est[:, :2] @ R.T + t
        dyaw = np.arctan2(R[1, 0], R[0, 0])
        est = np.concatenate([est_xy, (est[:, 2:] + dyaw)], -1)

    drift = kitti.kitti_drift(est, gt)
    ate = trajectory.ate_rmse(est[:, :2], gt[:, :2])
    lines = [f"t_err_percent: {drift['t_err_percent']}",
             f"r_err_deg_per_m: {drift['r_err_deg_per_m']}",
             f"n_subsequences: {drift['n_subsequences']}",
             f"ate_m: {ate}"]
    print("\n".join(lines))
    if args.output:
        with open(args.output, "w") as f:
            f.write("\n".join(lines) + "\n")
    if args.plot:
        viz.plot_trajectory(args.plot, est, gt)
        print(f"plot -> {args.plot}")


if __name__ == "__main__":
    main()
