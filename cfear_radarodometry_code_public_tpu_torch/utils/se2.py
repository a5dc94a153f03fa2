"""SE(2) pose algebra on tensors (port of `utils/se2.py`).

Poses are [x, y, theta] vectors batched over leading axes, and compose like
matrices: ``compose(a, b) == Ta @ Tb``.
"""

from __future__ import annotations

import math

import torch


def normalize_angle(a):
    """Wrap angle(s) to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def rotmat(theta):
    """(...,) -> (..., 2, 2) rotation matrices."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


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
