"""Trajectory collection, interpolation, export and alignment.

Host-side rebuild of `EvalTrajectory` (`eval_trajectory.{h,cpp}`):
- KITTI 3x4 row-major writer (`eval_trajectory.cpp:169-183`)
- TUM `t x y z qx qy qz qw` writer (`eval_trajectory.cpp:185-211`)
- covariance row writer (`eval_trajectory.cpp:214-232`)
- est<->GT one-to-one correspondence by linear time bracketing + slerp/lerp
  interpolation with z forced to 0 (`eval_trajectory.cpp:400-491`)
- Umeyama/SVD best-fit alignment (`eval_trajectory.cpp:343-395`)

Port of the reference's `eval/trajectory.py`: the same numpy code, with
`poses_to_matrices` over the port's `utils/se2.to_matrix` (numpy, float64).
`tests/test_torch_selfcontained.py` holds the writers byte-equal and the
readers, interpolation and alignment equal to the reference's.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from cfear_radarodometry_code_public_tpu_torch.utils import se2


# Oxford Radar RobotCar sequence-name -> KITTI index (dataset metadata,
# matching `DatasetToSequence`, `eval_trajectory.cpp:74-143`)
_OXFORD_SEQUENCES = [
    "2019-01-10-11-46-21-radar-oxford-10k",
    "2019-01-10-12-32-52-radar-oxford-10k",
    "2019-01-10-14-02-34-radar-oxford-10k",
    "2019-01-10-14-36-48-radar-oxford-10k-partial",
    "2019-01-10-14-50-05-radar-oxford-10k",
    "2019-01-10-15-19-41-radar-oxford-10k",
    "2019-01-11-12-26-55-radar-oxford-10k",
    "2019-01-11-13-24-51-radar-oxford-10k",
    "2019-01-11-14-02-26-radar-oxford-10k",
    "2019-01-11-14-37-14-radar-oxford-10k",
    "2019-01-14-12-05-52-radar-oxford-10k",
    "2019-01-14-12-41-28-radar-oxford-10k",
    "2019-01-14-13-38-21-radar-oxford-10k",
    "2019-01-14-14-15-12-radar-oxford-10k",
    "2019-01-14-14-48-55-radar-oxford-10k",
    "2019-01-15-12-01-32-radar-oxford-10k",
    "2019-01-15-12-52-32-radar-oxford-10k-partial",
    "2019-01-15-13-06-37-radar-oxford-10k",
    "2019-01-15-13-53-14-radar-oxford-10k",
    "2019-01-15-14-24-38-radar-oxford-10k",
    "2019-01-16-11-53-11-radar-oxford-10k",
    "2019-01-16-13-09-37-radar-oxford-10k",
    "2019-01-16-13-42-28-radar-oxford-10k",
    "2019-01-16-14-15-33-radar-oxford-10k",
    "2019-01-17-11-46-31-radar-oxford-10k",
    "2019-01-17-12-48-25-radar-oxford-10k",
    "2019-01-17-13-26-39-radar-oxford-10k",
    "2019-01-17-14-03-00-radar-oxford-10k",
    "2019-01-18-12-42-34-radar-oxford-10k",
    "2019-01-18-14-14-42-radar-oxford-10k",
    "2019-01-18-14-46-59-radar-oxford-10k",
    "2019-01-18-15-20-12-radar-oxford-10k",
]


def dataset_to_sequence(name: str) -> str:
    """Oxford sequence directory name -> KITTI-style file name ('01.txt'
    default, like the reference)."""
    try:
        return f"{_OXFORD_SEQUENCES.index(name):02d}.txt"
    except ValueError:
        return "01.txt"


def poses_to_matrices(poses_xyt: np.ndarray) -> np.ndarray:
    """(T, 3) [x, y, yaw] -> (T, 4, 4) homogeneous."""
    return se2.to_matrix(poses_xyt)


def write_kitti(path: str, mats: np.ndarray) -> None:
    """KITTI odometry format: 12 numbers (3x4 row-major) per line."""
    with open(path, "w") as f:
        for m in mats:
            row = m[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


def read_kitti(path: str) -> np.ndarray:
    data = np.loadtxt(path).reshape(-1, 3, 4)
    mats = np.tile(np.eye(4), (data.shape[0], 1, 1))
    mats[:, :3, :4] = data
    return mats


def _yaw_quat(theta: np.ndarray):
    """z-axis rotation quaternion (x, y, z, w)."""
    half = theta / 2.0
    z = np.sin(half)
    w = np.cos(half)
    zero = np.zeros_like(z)
    return np.stack([zero, zero, z, w], -1)


def write_tum(path: str, stamps: Sequence[float], poses_xyt: np.ndarray) -> None:
    quat = _yaw_quat(poses_xyt[:, 2])
    with open(path, "w") as f:
        for t, p, q in zip(stamps, poses_xyt, quat):
            sec = int(t)
            nsec = int(round((t - sec) * 1e9))
            f.write(f"{sec}.{nsec:09d} "
                    f"{p[0]:.4f} {p[1]:.4f} {0.0:.4f} "
                    f"{q[0]:g} {q[1]:g} {q[2]:g} {q[3]:g}\n")


def write_cov(path: str, stamps: Sequence[float], covs: np.ndarray) -> None:
    with open(path, "w") as f:
        for t, c in zip(stamps, covs):
            sec = int(t)
            nsec = int(round((t - sec) * 1e9))
            f.write(f"{sec}.{nsec:09d} "
                    + " ".join(f"{v:g}" for v in np.asarray(c).reshape(-1))
                    + "\n")


def interpolate_gt(est_stamps: np.ndarray, gt_stamps: np.ndarray,
                   gt_poses: np.ndarray):
    """For each est stamp inside the GT time range, lerp GT pose
    (`One2OneCorrespondance` + `pose_interp`). Returns (est_indices, gt_interp).
    """
    keep, interp = [], []
    for i, t in enumerate(est_stamps):
        j = np.searchsorted(gt_stamps, t) - 1
        if j < 0 or j + 1 >= len(gt_stamps):
            continue
        t0, t1 = gt_stamps[j], gt_stamps[j + 1]
        if not (t0 <= t <= t1):
            continue
        alpha = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        p0, p1 = gt_poses[j], gt_poses[j + 1]
        dth = se2_angle_diff(p1[2], p0[2])
        pose = np.array([
            (1 - alpha) * p0[0] + alpha * p1[0],
            (1 - alpha) * p0[1] + alpha * p1[1],
            p0[2] + alpha * dth,
        ])
        keep.append(i)
        interp.append(pose)
    return np.asarray(keep, int), np.asarray(interp).reshape(-1, 3)


def se2_angle_diff(a, b):
    d = a - b
    return np.arctan2(np.sin(d), np.cos(d))


def umeyama_align(est_xy: np.ndarray, gt_xy: np.ndarray, with_scale=False):
    """Best-fit rigid transform mapping est -> gt (Umeyama / SVD,
    `best_fit_transform`, `eval_trajectory.cpp:343-395`). Returns (R, t, s)."""
    mu_e = est_xy.mean(0)
    mu_g = gt_xy.mean(0)
    xe = est_xy - mu_e
    xg = gt_xy - mu_g
    cov = xg.T @ xe / est_xy.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(cov.shape[0])
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[-1, -1] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_e = (xe ** 2).sum() / est_xy.shape[0]
        s = (D * np.diag(S)).sum() / var_e
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est_xy: np.ndarray, gt_xy: np.ndarray, align=True) -> float:
    """Absolute trajectory error (RMSE, meters) after optional alignment."""
    if align:
        R, t, _ = umeyama_align(est_xy, gt_xy)
        est_xy = est_xy @ R.T + t
    return float(np.sqrt(((est_xy - gt_xy) ** 2).sum(-1).mean()))


def save_trajectories(directory: str, name: str, stamps, est_xyt, covs=None,
                      gt_xyt=None) -> None:
    """Write est (+gt) in KITTI + TUM + cov formats (`Save()`,
    `eval_trajectory.cpp:265-315`)."""
    est_dir = os.path.join(directory, "est")
    os.makedirs(est_dir, exist_ok=True)
    write_kitti(os.path.join(est_dir, f"{name}.txt"),
                poses_to_matrices(est_xyt))
    write_tum(os.path.join(est_dir, f"{name}_tum.txt"), stamps, est_xyt)
    if covs is not None:
        write_cov(os.path.join(est_dir, f"{name}_cov.txt"), stamps, covs)
    if gt_xyt is not None:
        gt_dir = os.path.join(directory, "gt")
        os.makedirs(gt_dir, exist_ok=True)
        write_kitti(os.path.join(gt_dir, f"{name}.txt"),
                    poses_to_matrices(gt_xyt))
        write_tum(os.path.join(gt_dir, f"{name}_tum.txt"), stamps, gt_xyt)
