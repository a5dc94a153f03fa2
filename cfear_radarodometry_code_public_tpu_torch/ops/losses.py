"""Robust loss functions with Ceres semantics (port of `ops/losses.py`).

rho(s) operates on the SQUARED residual norm s = ||r||^2 and returns
(rho(s), rho'(s)). A Python number divided by a tensor is written as
`_rdiv`: torch evaluates `c / t` as `t.reciprocal() * c`, which rounds
differently from the true division the reference computes.
"""

from __future__ import annotations

import torch


def _rdiv(c: float, t):
    """c / t as an IEEE division (see the module docstring)."""
    return torch.div(t.new_full((), c), t)


def _huber(s, a):
    b = a * a
    big = s > b
    sq = torch.sqrt(torch.clamp(s, min=1e-30))
    rho = torch.where(big, 2.0 * a * sq - b, s)
    drho = torch.where(big, _rdiv(a, sq), torch.ones_like(s))
    return rho, drho


def _cauchy(s, a):
    b = a * a
    rho = b * torch.log1p(s / b)
    drho = _rdiv(1.0, 1.0 + s / b)
    return rho, drho


def _soft_l_one(s, a):
    b = a * a
    t = torch.sqrt(1.0 + s / b)
    return 2.0 * b * (t - 1.0), _rdiv(1.0, t)


def _tukey(s, a):
    b = a * a
    t = torch.clamp(1.0 - s / b, min=0.0)
    rho = b / 3.0 * (1.0 - t * t * t)
    return rho, t * t


def _dcs(s, a):
    """Dynamic Covariance Scaling: IRLS weight min(1, 2a/(a+s))^2 and rho
    its antiderivative (s for s <= a, 3a - 4a^2/(a+s) beyond)."""
    s = torch.clamp(s, min=0.0)
    w = torch.clamp(_rdiv(2.0 * a, a + s), max=1.0) ** 2
    rho = torch.where(s <= a, s, 3.0 * a - _rdiv(4.0 * a * a, a + s))
    return rho, w


def rho(s, loss: str, limit: float):
    """(rho(s), rho'(s)) for the configured loss."""
    if loss == "None":
        return s, torch.ones_like(s)
    if loss == "DCS":
        return _dcs(s, limit)
    if loss == "Huber":
        return _huber(s, limit)
    if loss == "Cauchy":
        return _cauchy(s, limit)
    if loss == "SoftLOne":
        return _soft_l_one(s, limit)
    if loss == "Tukey":
        return _tukey(s, limit)
    if loss == "Combined":
        # ceres::ComposedLoss(Huber(1), Cauchy(1)): rho = f(g(s))
        g, dg = _cauchy(s, 1.0)
        f, df = _huber(g, 1.0)
        return f, df * dg
    raise ValueError(f"unknown loss '{loss}'")


def similarity(x, y):
    """2 min(x, y) / (x + y) (`registration.h:96`)."""
    return 2.0 * torch.minimum(x, y) / torch.clamp(x + y, min=1e-12)


def association_weight(opt: str, n_src, n_tar, sim_dir, plan_src, plan_tar):
    """Residual weight per association (`registration.cpp:67-76`)."""
    if opt == "Uniform":
        return torch.ones_like(sim_dir)
    if opt == "Sim_N":
        return similarity(n_src, n_tar)
    if opt == "Sim_direction":
        return sim_dir
    if opt == "Sim_scale":
        return similarity(plan_src, plan_tar)
    if opt == "Combined":
        return (similarity(n_src, n_tar) + sim_dir
                + similarity(plan_src, plan_tar))
    raise ValueError(f"unknown weight option '{opt}'")
