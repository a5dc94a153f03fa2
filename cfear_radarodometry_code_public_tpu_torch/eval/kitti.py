"""Self-contained KITTI-odometry drift evaluator.

The reference scores trajectories with the external `kitti-odom-eval` /
`radar_kitti_benchmark` repos (SURVEY.md §4, `README.md:68-90`). This module
implements the same metric in-repo: for every start pose (every `step_size`
frames) and every subsequence length in {100, ..., 800} m measured along the
ground-truth path, the relative-pose error between est and GT over that
subsequence yields a translational drift (%) and rotational drift (deg/m);
results are averaged over all subsequences.

The port's own copy of the reference's
`cfear_radarodometry_code_public_tpu/eval/kitti.py` (framework-free; the
port imports nothing of the reference package). The two are held equal by
`tests/test_torch_selfcontained.py`: `kitti_drift` agrees with the
reference's to 1e-12.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def _trajectory_distances(gt_xy: np.ndarray) -> np.ndarray:
    d = np.zeros(len(gt_xy))
    if len(gt_xy) > 1:
        seg = np.linalg.norm(np.diff(gt_xy, axis=0), axis=1)
        d[1:] = np.cumsum(seg)
    return d


def _pose_mats(poses_xyt: np.ndarray) -> np.ndarray:
    c, s = np.cos(poses_xyt[:, 2]), np.sin(poses_xyt[:, 2])
    m = np.tile(np.eye(3), (len(poses_xyt), 1, 1))
    m[:, 0, 0], m[:, 0, 1], m[:, 0, 2] = c, -s, poses_xyt[:, 0]
    m[:, 1, 0], m[:, 1, 1], m[:, 1, 2] = s, c, poses_xyt[:, 1]
    return m


def _inv(m: np.ndarray) -> np.ndarray:
    out = np.eye(3)
    R = m[:2, :2]
    out[:2, :2] = R.T
    out[:2, 2] = -R.T @ m[:2, 2]
    return out


def kitti_drift(est_xyt: np.ndarray, gt_xyt: np.ndarray,
                step_size: int = 10,
                lengths: Tuple[float, ...] = LENGTHS) -> Dict[str, float]:
    """KITTI-style average drift of `est` against `gt` (both (T, 3) [x,y,yaw]).

    Returns dict with `t_err_percent`, `r_err_deg_per_m`, `n_subsequences`,
    and per-length breakdowns.
    """
    assert est_xyt.shape == gt_xyt.shape
    dist = _trajectory_distances(gt_xyt[:, :2])
    est_m = _pose_mats(est_xyt)
    gt_m = _pose_mats(gt_xyt)

    t_errs, r_errs, used_len = [], [], []
    for first in range(0, len(gt_xyt), step_size):
        for length in lengths:
            target = dist[first] + length
            last = int(np.searchsorted(dist, target))
            if last >= len(gt_xyt):
                continue
            gt_rel = _inv(gt_m[first]) @ gt_m[last]
            est_rel = _inv(est_m[first]) @ est_m[last]
            err = _inv(est_rel) @ gt_rel
            t_err = np.linalg.norm(err[:2, 2])
            r_err = abs(np.arctan2(err[1, 0], err[0, 0]))
            t_errs.append(t_err / length)
            r_errs.append(r_err / length)
            used_len.append(length)

    if not t_errs:
        return dict(t_err_percent=float("nan"), r_err_deg_per_m=float("nan"),
                    n_subsequences=0)
    t_errs = np.asarray(t_errs)
    r_errs = np.asarray(r_errs)
    used_len = np.asarray(used_len)
    per_length = {}
    for length in lengths:
        sel = used_len == length
        if sel.any():
            per_length[int(length)] = dict(
                t_err_percent=float(t_errs[sel].mean() * 100.0),
                r_err_deg_per_m=float(np.degrees(r_errs[sel].mean())),
                n=int(sel.sum()))
    return dict(
        t_err_percent=float(t_errs.mean() * 100.0),
        r_err_deg_per_m=float(np.degrees(r_errs.mean())),
        n_subsequences=len(t_errs),
        per_length=per_length,
    )
