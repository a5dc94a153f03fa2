"""Absolute trajectory error (port of `eval/trajectory.py:umeyama_align`
and `ate_rmse`; the reference module also holds SE(2) trajectory helpers
over its JAX se2, which the port does not need). The KITTI drift metric is
`eval/kitti.py`."""

from __future__ import annotations

import numpy as np


def umeyama_align(est_xy: np.ndarray, gt_xy: np.ndarray):
    """Best-fit rigid transform (R, t) mapping est -> gt (Umeyama / SVD)."""
    mu_e, mu_g = est_xy.mean(0), gt_xy.mean(0)
    cov = (gt_xy - mu_g).T @ (est_xy - mu_e) / est_xy.shape[0]
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(cov.shape[0])
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[-1, -1] = -1
    R = U @ S @ Vt
    return R, mu_g - R @ mu_e


def ate_rmse(est_xy: np.ndarray, gt_xy: np.ndarray, align=True) -> float:
    """Absolute trajectory error (RMSE, metres) after rigid alignment."""
    if align:
        R, t = umeyama_align(est_xy, gt_xy)
        est_xy = est_xy @ R.T + t
    return float(np.sqrt(((est_xy - gt_xy) ** 2).sum(-1).mean()))
