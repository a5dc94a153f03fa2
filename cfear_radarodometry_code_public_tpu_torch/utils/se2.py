"""SE(2) pose algebra on tensors (port of `utils/se2.py`).

Poses are [x, y, theta] vectors batched over leading axes, and compose like
matrices: ``compose(a, b) == Ta @ Tb``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def normalize_angle(a):
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def rotmat(theta):
    """(...,) -> (..., 2, 2) rotation matrices."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def identity(dtype=torch.float32, device=None):
    return torch.zeros((3,), dtype=dtype, device=device)


def compose(a, b):
    """T_a * T_b for [x, y, theta] poses (batched)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = a[..., 2] + b[..., 2]
    return torch.stack([x, y, t], -1)


def inverse(a):
    """T^{-1} for [x, y, theta] poses (batched)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return torch.stack([x, y, -a[..., 2]], -1)


def relative(a, b):
    """T_a^{-1} * T_b (the motion taking frame a to frame b)."""
    return compose(inverse(a), b)


def transform(pose, pts):
    """Apply pose [x,y,theta] (..., 3) to points (..., N, 2)."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([c * x - s * y + pose[..., 0, None],
                        s * x + c * y + pose[..., 1, None]], -1)


def rotate(pose, vecs):
    """Apply only the rotation of pose (..., 3) to vectors (..., N, 2)."""
    c = torch.cos(pose[..., 2])[..., None]
    s = torch.sin(pose[..., 2])[..., None]
    x, y = vecs[..., 0], vecs[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], -1)


def scaled(pose, factor):
    """Fractional motion: translation and angle scaled by `factor`
    (getScaledRotationMatrix/TranslationVector, `utils.cpp:130-146`)."""
    return torch.stack([pose[..., 0] * factor, pose[..., 1] * factor,
                        pose[..., 2] * factor], -1)


def exp(xi):
    """SE(2) exponential map: twist [vx, vy, omega] -> pose [x, y, theta]."""
    w = xi[..., 2]
    small = w.abs() < 1e-6
    ws = torch.where(small, torch.ones_like(w), w)
    s, c = torch.sin(ws), torch.cos(ws)
    a = torch.where(small, 1.0 - w * w / 6.0, s / ws)               # sin(w)/w
    b = torch.where(small, w / 2.0 - w ** 3 / 24.0, (1 - c) / ws)   # (1-cos w)/w
    return torch.stack([a * xi[..., 0] - b * xi[..., 1],
                        b * xi[..., 0] + a * xi[..., 1], w], -1)


def log(pose):
    """SE(2) logarithm map: pose [x, y, theta] -> twist [vx, vy, omega]."""
    w = normalize_angle(pose[..., 2])
    small = w.abs() < 1e-6
    ws = torch.where(small, torch.ones_like(w), w)
    half = ws / 2.0
    a = torch.where(small, 1.0 - w * w / 12.0,
                    half * torch.cos(half) / torch.sin(half))    # (w/2) cot(w/2)
    b = w / 2.0
    return torch.stack([a * pose[..., 0] + b * pose[..., 1],
                        -b * pose[..., 0] + a * pose[..., 1], w], -1)


def to_matrix(pose):
    """[x, y, theta] -> 4x4 homogeneous float64 numpy matrix (host side,
    for trajectory export)."""
    pose = np.asarray(pose, dtype=np.float64)
    c, s = np.cos(pose[..., 2]), np.sin(pose[..., 2])
    m = np.zeros(pose.shape[:-1] + (4, 4), dtype=np.float64)
    m[..., 0, 0], m[..., 0, 1] = c, -s
    m[..., 1, 0], m[..., 1, 1] = s, c
    m[..., 2, 2] = 1.0
    m[..., 3, 3] = 1.0
    m[..., 0, 3] = pose[..., 0]
    m[..., 1, 3] = pose[..., 1]
    return m


def from_matrix(m):
    """4x4 (or 3x3 / 3x4) homogeneous matrix -> [x, y, theta] (host side)."""
    m = np.asarray(m)
    theta = np.arctan2(m[..., 1, 0], m[..., 0, 0])
    return np.stack([m[..., 0, -1], m[..., 1, -1], theta], -1)


def rel_timestamp(xy, ccw: bool):
    """Relative scan time in [-0.5, 0.5] of point(s) from azimuth
    (GetRelTimeStamp, `utils.h:28-32`)."""
    a = torch.atan2(xy[..., 1], xy[..., 0])
    d = torch.where(a > 0.00001, a, 2.0 * math.pi + a) / (2.0 * math.pi)
    return -(d - 0.5) if ccw else d - 0.5


def compensate_points(xy, tmot, ccw: bool):
    """Motion-distortion compensate points (..., N, 2) by fractional
    application of the previous motion tmot (..., 3) (`utils.cpp:96-107`)."""
    d = rel_timestamp(xy, ccw)                       # (..., N)
    ang = d * tmot[..., None, 2]
    c, s = torch.cos(ang), torch.sin(ang)
    x, y = xy[..., 0], xy[..., 1]
    xr = c * x - s * y + d * tmot[..., None, 0]
    yr = s * x + c * y + d * tmot[..., None, 1]
    return torch.stack([xr, yr], -1)
