"""Scan-to-multi-keyframe registration (port of `ops/registration.py`).

Batched over a leading lane axis (B = 1 is the single sequence): the newest
scan of each lane is registered against that lane's S keyframes; only its
pose is free. Outer association loop (at most `max_itr_association`
iterations): world-frame attributes packed once, exact 1-NN association
(CUDA kernels A/C or the dense matmul form), gates and weights, then the
packed LM solve (`lm.lm_solve_packed`: CUDA kernel F on a card, one launch
per solve; the plain loop on the CPU). The reference's `while_loop` becomes
a fixed-trip loop in which a finished lane keeps its state, with an early
stop once every lane is done. Afterwards the Censi-scaled covariance.
With `soft_constraint` the inner solve is the reference's einsum LM with
the guess prior (`_lm_solve`), which does not go through kernel F, as in
the reference.

The cost-evaluation entry points (`get_cost`, `sample_covariance`,
`cost_surface`) ride the same association backends: the poses they
evaluate are folded into the lane axis, with the keyframe window gated and
packed once, so one association pass serves all of them. Also ported:
`register_time_continuous`, `is_consistent`, `register_scans_service`.
`assoc_method="grid"` (`build_buckets`, `associate`): the reference's
bucket-grid exact 1-NN, a parity ablation that the reference's config calls
~400x slower than the kernels, runs as torch ops on either device (no
kernel, as the reference runs it as XLA).
`refine_many_to_many`, the joint refinement of all scan poses, is ported
with the SLAM slice: its inline dense 1-NN is the reference's matmul form
(outside any kernel, as there), and its Gauss-Newton normal equations are
solved matrix-free through `torch.func.jvp`/`vjp` with the IRLS weight
detached.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc, lm, losses
from cfear_radarodometry_code_public_tpu_torch.ops.features import (
    CellMap, compensate_cells)
from cfear_radarodometry_code_public_tpu_torch.utils import se2


class Associations(NamedTuple):
    """One slot per (keyframe, source cell), per lane."""

    tar_idx: torch.Tensor    # (B, S, M) int32 — nearest target cell
    weight: torch.Tensor     # (B, S, M) float32 — 0 where invalid
    valid: torch.Tensor      # (B, S, M) bool


class RegistrationResult(NamedTuple):
    pose: torch.Tensor        # (B, 3) refined pose of the newest scan
    cov: torch.Tensor         # (B, 3, 3) Censi-scaled covariance
    success: torch.Tensor     # (B,) bool
    score: torch.Tensor       # (B,) final cost / num residual scalars
    final_cost: torch.Tensor  # (B,)
    num_assoc: torch.Tensor   # (B,) int32
    iterations: torch.Tensor  # (B,) int32 — outer iterations executed


_FAST_DENSE = ("dense", "pallas", "pallas_sparse")


def check_supported(cfg) -> None:
    """Raise for an unknown association method."""
    reg = cfg.registration
    if reg.assoc_method not in ("auto", "grid") + _FAST_DENSE:
        raise ValueError(f"unknown assoc_method '{reg.assoc_method}'")


def _chol2_lower(a, b, c):
    """Lower Cholesky of SPD [[a, b], [b, c]] (batched scalars)."""
    l11 = torch.sqrt(torch.clamp(a, min=1e-30))
    l21 = b / l11
    l22 = torch.sqrt(torch.clamp(c - l21 * l21, min=1e-30))
    return l11, l21, l22


def _world_attrs(kf_cells: CellMap, kf_poses, cfg):
    """Keyframe cells (B, S, M, ...) moved into the registration frame once:
    (B, S, M, D) rows [mx, my, nx, ny, nsamples, planarity, valid]
    (+ [l11, l21, l22] sqrt-information for P2D)."""
    reg = cfg.registration
    mean = se2.transform(kf_poses, kf_cells.mean)
    normal = se2.rotate(kf_poses, kf_cells.normal)
    cols = [mean, normal, kf_cells.nsamples[..., None],
            kf_cells.planarity[..., None],
            kf_cells.valid.to(mean.dtype)[..., None]]
    if reg.cost == "P2D":
        R = se2.rotmat(kf_poses[..., 2])                      # (B, S, 2, 2)
        cov_w = torch.einsum("bsij,bsnjk,bslk->bsnil", R, kf_cells.cov, R)
        cov_w = (cov_w + reg.regularization
                 * torch.eye(2, dtype=cov_w.dtype, device=cov_w.device)
                 ) * reg.cov_scale
        det = (cov_w[..., 0, 0] * cov_w[..., 1, 1]
               - cov_w[..., 0, 1] * cov_w[..., 1, 0])
        det = torch.clamp(det, min=1e-20)
        ia = cov_w[..., 1, 1] / det
        ib = -cov_w[..., 0, 1] / det
        ic = cov_w[..., 0, 0] / det
        cols.append(torch.stack(_chol2_lower(ia, ib, ic), -1))
    return torch.cat(cols, -1)


def _tgt_from_attrs(g, cfg):
    """Attribute rows (..., D) -> the target-terms dict."""
    tgt = {"mean": g[..., 0:2], "normal": g[..., 2:4]}
    if cfg.registration.cost == "P2D":
        tgt["sqrt_info"] = g[..., 7:10]
    return tgt


def _gather_attrs(attrs, nn):
    """attrs (B, S, M, D), nn (B, S, Msrc) -> (B, S, Msrc, D): one flat
    gather with the keyframe axis folded into the row index."""
    b, s, m, d = attrs.shape
    flat = (nn.to(torch.int64)
            + (torch.arange(s, device=nn.device) * m)[None, :, None])
    rows = torch.gather(attrs.reshape(b, s * m, d), 1,
                        flat.reshape(b, -1, 1).expand(-1, -1, d))
    return rows.reshape(b, s, nn.shape[2], d)


def _associate_world(attrs, src: CellMap, src_pose, kf_valid, radius, cfg,
                     cos_gate, method: str = "dense"):
    """Exact 1-NN association in the shared registration frame.
    attrs (B, S, M, D), src leaves (B, M, ...), src_pose (B, 3),
    kf_valid (B, S), radius (B,). Returns (Associations, target terms)."""
    reg = cfg.registration
    src_mean_w = se2.transform(src_pose, src.mean)            # (B, M, 2)
    src_norm_w = se2.rotate(src_pose, src.normal)
    tar_xy = attrs[..., 0:2].contiguous()
    tar_valid = (attrs[..., 6] > 0.5) & kf_valid[..., None]
    if method == "pallas":
        nn_all, d2_all = cuda_assoc.nn_min(src_mean_w.contiguous(), tar_xy,
                                           tar_valid)
    elif method == "pallas_sparse":
        sb = cuda_assoc.tile_bounds(src_mean_w, src.valid,
                                    cuda_assoc.TS_SPARSE)
        tb = cuda_assoc.tile_bounds(tar_xy, tar_valid, cuda_assoc.TT_SPARSE)
        nn_all, d2_all = cuda_assoc.nn_min_sparse(
            src_mean_w.contiguous(), sb.contiguous(), tar_xy, tb.contiguous(),
            tar_valid, radius.contiguous())
    else:
        # |s|^2 + |t|^2 - 2 s.t with a full-f32 matmul (TF32 is off)
        src_n2 = (src_mean_w ** 2).sum(-1)                    # (B, Msrc)
        d2 = (src_n2[:, None, :, None] + (tar_xy ** 2).sum(-1)[:, :, None, :]
              - 2.0 * torch.matmul(src_mean_w[:, None], tar_xy.transpose(-1, -2)))
        d2 = torch.where((attrs[..., 6] > 0.5)[:, :, None, :], d2,
                         d2.new_full((), float("inf")))
        nn_all = torch.argmin(d2, dim=-1).to(torch.int32)
        d2_all = d2.amin(-1)

    g = _gather_attrs(attrs, nn_all)
    sim_dir = torch.clamp((src_norm_w[:, None] * g[..., 2:4]).sum(-1), min=0.0)
    ok = (src.valid[:, None] & kf_valid[..., None] & (g[..., 6] > 0.5)
          & (d2_all < (radius * radius)[:, None, None]) & (sim_dir > cos_gate))
    w = losses.association_weight(
        reg.weight_opt, src.nsamples[:, None], g[..., 4], sim_dir,
        src.planarity[:, None], g[..., 5])
    return (Associations(nn_all, torch.where(ok, w, w.new_zeros(())), ok),
            _tgt_from_attrs(g, cfg))


def _take(a, idx):
    """Rows of per-keyframe cell leaves a (B, S, M, ...) at idx (B, S, ...)
    -> (B, S, ..., leaf tail)."""
    b, s, m = a.shape[:3]
    tail = a.shape[3:]
    width = math.prod(tail)
    flat = idx.reshape(b, s, -1, 1).to(torch.int64).expand(-1, -1, -1, width)
    out = torch.gather(a.reshape(b, s, m, width), 2, flat)
    return out.reshape(idx.shape + tail)


def _bucket_geometry(cfg):
    """Static bucket grid: bin size = the largest search radius (the
    coarse-to-fine first iteration uses 2 * assoc_radius), so the exact 1-NN
    within radius is always inside the 3x3 bucket neighborhood."""
    bin_size = 2.0 * cfg.registration.assoc_radius
    half = int(math.ceil(cfg.radar.max_usable_range / bin_size)) + 2
    return bin_size, 2 * half


def build_buckets(cells: CellMap, cfg) -> torch.Tensor:
    """Bucket tables over scans' cell means: leaves (..., M, ...) ->
    (..., G*G*C + 1) int32 of cell indices, -1 where empty (C =
    `bucket_capacity`; the last slot is the overflow sink). A stable sort by
    bucket id ranks the cells of a bucket by index, as the reference's
    `jnp.argsort`. The reference writes every cell that has no slot (outside
    the grid, invalid, or beyond a full bucket) to the sink, last writer
    winning; here the sink is left at -1. A lookup reads the sink only for
    a neighbour bucket outside the grid, and there the reference's sink
    holds an invalid cell (invalid cells sort last) whenever the scan has
    one, which the validity gate drops: no candidate either way."""
    bin_size, g = _bucket_geometry(cfg)
    cap = cfg.registration.bucket_capacity
    lead, m = cells.valid.shape[:-1], cells.valid.shape[-1]
    mean = cells.mean.reshape(-1, m, 2)
    valid = cells.valid.reshape(-1, m)
    bi = torch.floor(mean / mean.new_tensor(bin_size)).to(torch.int32) \
        + g // 2
    in_grid = valid & ((bi >= 0) & (bi < g)).all(-1)
    bid = torch.where(in_grid, bi[..., 0] * g + bi[..., 1],
                      bi.new_full((), g * g))
    order = torch.argsort(bid, dim=-1, stable=True)
    sorted_bid = torch.gather(bid, 1, order).contiguous()
    # rank within each run of equal bucket ids
    first = torch.searchsorted(sorted_bid, sorted_bid, side="left")
    rank = torch.arange(m, device=bid.device) - first
    sink = g * g * cap
    slot = torch.where((rank < cap) & (sorted_bid < g * g),
                       sorted_bid.to(torch.int64) * cap + rank, sink + 1)
    # every slot below the sink is written once; the rest go to a dump slot
    # past the sink, cut off afterwards
    table = torch.full((mean.shape[0], sink + 2), -1, dtype=torch.int32,
                       device=bid.device)
    table.scatter_(1, slot, order.to(torch.int32))
    return table[:, :sink + 1].reshape(lead + (sink + 1,))


def _nn_grid(kf_cells: CellMap, table, src_mean_t, cfg):
    """Exact 1-NN via 3x3 bucket lookup: kf_cells leaves (B, S, M, ...),
    table (B, S, G*G*C + 1), src_mean_t (B, S, Msrc, 2) the source means in
    each keyframe's frame. Candidates in the reference's order (neighbour
    bucket, then slot), the first at the least distance winning; +inf where
    no valid candidate. Returns (nn, d2), each (B, S, Msrc)."""
    bin_size, g = _bucket_geometry(cfg)
    cap = cfg.registration.bucket_capacity
    sink = g * g * cap
    bi = torch.floor(src_mean_t / src_mean_t.new_tensor(bin_size)).to(
        torch.int32) + g // 2
    slots = torch.arange(cap, device=bi.device)
    cand = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            tx, ty = bi[..., 0] + dx, bi[..., 1] + dy
            ok = (tx >= 0) & (tx < g) & (ty >= 0) & (ty < g)
            base = torch.where(ok, (tx * g + ty).to(torch.int64) * cap, sink)
            cand.append(base[..., None] + slots)
    cand = torch.clamp(torch.cat(cand, -1), max=sink)          # (B, S, Msrc, 9C)
    b, s = cand.shape[:2]
    idx = torch.gather(table.to(torch.int64), 2,
                       cand.reshape(b, s, -1)).reshape(cand.shape)
    idx_safe = torch.clamp(idx, min=0)
    diff = src_mean_t[..., None, :] - _take(kf_cells.mean, idx_safe)
    d2 = (diff ** 2).sum(-1)
    d2 = torch.where((idx >= 0) & _take(kf_cells.valid, idx_safe), d2,
                     d2.new_full((), float("inf")))
    j = torch.argmin(d2, dim=-1, keepdim=True)
    return (torch.gather(idx_safe, -1, j)[..., 0],
            torch.gather(d2, -1, j)[..., 0])


def _nn_dense_local(kf_cells: CellMap, src_mean_t):
    """Exact 1-NN in each keyframe's frame by the dense (Msrc, M) matrix in
    the |s|^2 + |t|^2 - 2 s.t form, +inf at invalid targets. Returns (nn,
    d2), each (B, S, Msrc)."""
    tar = kf_cells.mean
    d2 = ((src_mean_t ** 2).sum(-1)[..., None] + (tar ** 2).sum(-1)[:, :, None]
          - 2.0 * torch.matmul(src_mean_t, tar.transpose(-1, -2)))
    d2 = torch.where(kf_cells.valid[:, :, None], d2,
                     d2.new_full((), float("inf")))
    nn = torch.argmin(d2, dim=-1)
    return nn, torch.gather(d2, -1, nn[..., None])[..., 0]


def associate(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap, src_pose,
              radius, cfg, buckets=None) -> Associations:
    """1-NN association of each lane's source cells to each of its
    keyframes' cells (`AddScanPairCost`, `n_scan_normal.cpp:215-263`):
    source means moved into each keyframe's local frame with
    T_tar^-1 T_src, matched to the exact nearest target cell, gated by
    `radius` (a float or (B,)) and by normal agreement
    dot(R_rel n_src, n_tar) > cos(angle_outlier_deg); weights per the
    configured option. kf_cells leaves (B, S, M, ...), kf_poses (B, S, 3),
    kf_valid (B, S), src leaves (B, Msrc, ...), src_pose (B, 3).

    With `assoc_method="grid"` the 3x3 neighbourhood of a per-keyframe
    bucket table (`build_buckets`, or `buckets` (B, S, G*G*C + 1) built
    once by the caller); otherwise the dense distance matrix."""
    reg = cfg.registration
    cos_gate = math.cos(math.radians(reg.angle_outlier_deg))
    b = src_pose.shape[0]
    radius = torch.as_tensor(radius, dtype=src_pose.dtype,
                             device=src_pose.device).expand(b)
    t_rel = se2.relative(kf_poses, src_pose[:, None])          # (B, S, 3)
    src_mean_t = se2.transform(t_rel, src.mean[:, None])     # (B, S, Msrc, 2)
    src_norm_t = se2.rotate(t_rel, src.normal[:, None])
    if reg.assoc_method == "grid":
        if buckets is None:
            buckets = build_buckets(kf_cells, cfg)
        nn, nn_d2 = _nn_grid(kf_cells, buckets, src_mean_t, cfg)
    else:
        nn, nn_d2 = _nn_dense_local(kf_cells, src_mean_t)
    sim_dir = torch.clamp((src_norm_t * _take(kf_cells.normal, nn)).sum(-1),
                          min=0.0)
    ok = (src.valid[:, None] & kf_valid[..., None] & _take(kf_cells.valid, nn)
          & (nn_d2 < (radius * radius)[:, None, None]) & (sim_dir > cos_gate))
    w = losses.association_weight(
        reg.weight_opt, src.nsamples[:, None], _take(kf_cells.nsamples, nn),
        sim_dir, src.planarity[:, None], _take(kf_cells.planarity, nn))
    return Associations(nn.to(torch.int32), torch.where(ok, w, w.new_zeros(())),
                        ok)


def _residuals(pose, src: CellMap, tgt, cfg):
    """Residuals r (B, S, M, D) and Jacobians J (B, S, M, D, 3); D = 1 for
    P2L, 2 for P2P/P2D."""
    reg = cfg.registration
    c = torch.cos(pose[:, 2])[:, None]
    s = torch.sin(pose[:, 2])[:, None]
    mx, my = src.mean[..., 0], src.mean[..., 1]
    src_w = torch.stack([c * mx - s * my + pose[:, 0, None],
                         s * mx + c * my + pose[:, 1, None]], -1)
    dsrc_dth = torch.stack([-s * mx - c * my, c * mx - s * my], -1)
    diff = src_w[:, None] - tgt["mean"]                       # (B, S, M, 2)
    if reg.cost == "P2L":
        n = tgt["normal"]
        r = (diff * n).sum(-1, keepdim=True)
        jth = (n * dsrc_dth[:, None]).sum(-1)
        return r, torch.stack([n[..., 0], n[..., 1], jth], -1)[..., None, :]
    one, zero = torch.ones_like(diff[..., 0]), torch.zeros_like(diff[..., 0])
    jth = dsrc_dth[:, None].expand(diff.shape)
    J = torch.stack([torch.stack([one, zero], -1), torch.stack([zero, one], -1),
                     jth], -1)                                # (B, S, M, 2, 3)
    if reg.cost == "P2D":
        l11, l21, l22 = tgt["sqrt_info"].unbind(-1)
        r = torch.stack([l11 * diff[..., 0],
                         l21 * diff[..., 0] + l22 * diff[..., 1]], -1)
        J0 = l11[..., None] * J[..., 0, :]
        J1 = l21[..., None] * J[..., 0, :] + l22[..., None] * J[..., 1, :]
        return r, torch.stack([J0, J1], -2)
    return diff, J


def _soft_terms(pose, guess, soft_scale, soft_sqrt_info):
    """The guess prior's residual rs (B, 3) and Jacobian Js (B, 3, 3)
    (`n_scan_normal.cpp:373-377`): rs = scale * L (pose - guess), the angle
    difference wrapped."""
    d = pose - guess
    d = torch.stack([d[:, 0], d[:, 1], se2.normalize_angle(d[:, 2])], -1)
    js = soft_scale[:, None, None] * soft_sqrt_info
    return torch.einsum("bij,bj->bi", js, d), js


def _cost_only(pose, src, tgt, assoc: Associations, cfg, guess=None,
               soft_scale=None, soft_sqrt_info=None):
    """Total robust cost (B,) without gradient or Hessian; with
    `soft_sqrt_info`, plus the guess prior."""
    reg = cfg.registration
    r, _ = _residuals(pose, src, tgt, cfg)
    rho_s, _ = losses.rho((r * r).sum(-1), reg.loss, reg.loss_limit)
    cost = 0.5 * (assoc.weight * assoc.valid * rho_s).sum((-2, -1))
    if soft_sqrt_info is not None:
        rs, _ = _soft_terms(pose, guess, soft_scale, soft_sqrt_info)
        cost = cost + 0.5 * (rs * rs).sum(-1)
    return cost


def _cost_grad_hess(pose, src, tgt, assoc: Associations, cfg, guess=None,
                    soft_scale=None, soft_sqrt_info=None):
    """Total robust cost (B,), gradient (B, 3) and IRLS Gauss-Newton
    Hessian (B, 3, 3); with `soft_sqrt_info`, plus the guess prior."""
    reg = cfg.registration
    r, J = _residuals(pose, src, tgt, cfg)
    s = (r * r).sum(-1)
    rho_s, drho = losses.rho(s, reg.loss, reg.loss_limit)
    w = assoc.weight * assoc.valid
    cost = 0.5 * (w * rho_s).sum((-2, -1))
    wd = w * drho
    g = torch.einsum("bsm,bsmdp,bsmd->bp", wd, J, r)
    H = torch.einsum("bsm,bsmdp,bsmdq->bpq", wd, J, J)
    if soft_sqrt_info is not None:
        rs, js = _soft_terms(pose, guess, soft_scale, soft_sqrt_info)
        cost = cost + 0.5 * (rs * rs).sum(-1)
        g = g + torch.einsum("bip,bi->bp", js, rs)
        H = H + torch.einsum("bip,biq->bpq", js, js)
    return cost, g, H


def _solve3(A, b, eps=1e-30):
    """Closed-form 3x3 solve by the adjugate, batched: A (..., 3, 3),
    b (..., 3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = losses._rdiv(1.0, torch.where(det.abs() > eps, det,
                                            det.new_full((), eps)))
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
                        (c10 * b0 + c11 * b1 + c12 * b2) * inv_det,
                        (c20 * b0 + c21 * b1 + c22 * b2) * inv_det], -1)


def _inv3(A, eps=1e-30):
    """Closed-form 3x3 inverse (adjugate / det), batched."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    return torch.stack([_solve3(A, eye[:, i].expand(A.shape[:-1]), eps)
                        for i in range(3)], -1)


def _norm3(v):
    return torch.sqrt((v * v).sum(-1))


def _lm_solve(pose0, src, tgt, assoc: Associations, cfg, guess, soft_scale,
              soft_sqrt_info):
    """The reference's einsum trust-region LM (`_lm_solve`), batched over
    lanes: the `while_loop` becomes a fixed trip of `max_itr_solver`
    iterations in which a finished lane keeps its state, stopped early once
    every lane is done. Used with `soft_constraint` (the guess prior), as
    in the reference. Returns (pose (B, 3), cost, steps int32, last
    relative decrease), each per lane."""
    reg = cfg.registration
    b, dt, dev = pose0.shape[0], pose0.dtype, pose0.device

    def cgh(p):
        return _cost_grad_hess(p, src, tgt, assoc, cfg, guess, soft_scale,
                               soft_sqrt_info)

    pose = pose0
    cost, g, H = cgh(pose0)
    radius = torch.full((b,), 1e4, dtype=dt, device=dev)
    dec = torch.full((b,), 2.0, dtype=dt, device=dev)
    steps = torch.zeros(b, dtype=torch.int32, device=dev)
    last_rel = torch.full((b,), float("inf"), dtype=dt, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for _ in range(reg.max_itr_solver):
        if bool(done.all()):
            break
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-6, 1e32)
        delta = -_solve3(H + torch.diag_embed(diag / radius[:, None]), g)
        new_pose = pose + delta
        new_cost = _cost_only(new_pose, src, tgt, assoc, cfg, guess,
                              soft_scale, soft_sqrt_info)
        model_red = -((g * delta).sum(-1)
                      + 0.5 * (delta * torch.einsum("bpq,bq->bp", H, delta)
                               ).sum(-1))
        rel = (cost - new_cost) / torch.clamp(model_red, min=1e-30)
        accept = (rel > 1e-3) & torch.isfinite(new_cost)
        t = 2.0 * rel - 1.0
        shrink = 1.0 - t * t * t
        r_ok = radius / torch.clamp(torch.clamp(shrink, min=1.0 / 3.0),
                                    min=1e-3)
        r_bad = radius / dec
        func_conv = (cost - new_cost).abs() <= reg.function_tolerance * cost
        pred_conv = model_red <= reg.function_tolerance * cost
        step_small = _norm3(delta) <= 1e-8 * (_norm3(pose) + 1e-8)
        new_done = (accept & func_conv) | pred_conv | step_small \
            | (r_bad < 1e-32)
        cost2, g2, H2 = cgh(new_pose)
        # a lane that is done keeps its state; a rejected step keeps the
        # pose and its (cost, g, H)
        upd, take = ~done, ~done & accept
        pose = torch.where(take[:, None], new_pose, pose)
        cost = torch.where(take, cost2, cost)
        g = torch.where(take[:, None], g2, g)
        H = torch.where(take[:, None, None], H2, H)
        radius = torch.where(upd, torch.where(
            accept, torch.clamp(r_ok, max=1e16), r_bad), radius)
        dec = torch.where(upd, torch.where(accept, torch.full_like(dec, 2.0),
                                           dec * 2.0), dec)
        steps = steps + take.to(torch.int32)
        last_rel = torch.where(upd, rel, last_rel)
        done = done | new_done
    return pose, cost, steps, last_rel


def resolve_assoc_method(cfg, m_src: int, m_tar: int, s_act: int,
                         device) -> str:
    """Resolve `assoc_method="auto"`: the reference's policy with "on TPU"
    read as "on CUDA" — block-sparse kernel C for large Morton-ordered
    windows, else dense kernel A when the budget tiles, else the dense
    matmul form (always on the CPU)."""
    method = cfg.registration.assoc_method
    if method != "auto":
        return method
    on_gpu = torch.device(device).type == "cuda"
    if (on_gpu and cfg.feature.spatial_sort and s_act >= 8
            and cuda_assoc.supported_sparse(m_src, m_tar)):
        return "pallas_sparse"
    if on_gpu and cuda_assoc.supported(m_src):
        return "pallas"
    return "dense"


def _active_window(kf_cells: CellMap, kf_poses, kf_valid, center, cfg):
    """Keyframe-axis distance gate (`max_active_keyframes`): keep the K
    keyframes nearest `center` (B, 3), in the reference's top_k order."""
    k = cfg.registration.max_active_keyframes
    s_all = kf_valid.shape[1]
    if not k or k >= s_all:
        return kf_cells, kf_poses, kf_valid
    d2_kf = ((kf_poses[..., :2] - center[:, None, :2]) ** 2).sum(-1)
    d2_kf = torch.where(kf_valid, d2_kf, d2_kf.new_full((), float("inf")))
    sel = torch.argsort(d2_kf, dim=-1, stable=True)[:, :k]    # (B, K)

    def take(a):
        idx = sel.reshape(sel.shape + (1,) * (a.dim() - 2))
        return torch.gather(a, 1, idx.expand(sel.shape + a.shape[2:]))

    return CellMap(*(take(a) for a in kf_cells)), take(kf_poses), take(kf_valid)


def register(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap, guess,
             reg_cov_guess=None, cfg=None) -> RegistrationResult:
    """Register each lane's newest scan against its S keyframes.

    kf_cells leaves (B, S, M, ...) in their local frames, kf_poses (B, S, 3)
    FIXED poses, kf_valid (B, S), src leaves (B, M, ...) in its local frame,
    guess (B, 3). With `soft_constraint`, `reg_cov_guess` (B, 3, 3; the
    identity when None) is the covariance of the guess prior."""
    check_supported(cfg)
    reg = cfg.registration
    dtype, dev = guess.dtype, guess.device
    b = guess.shape[0]
    res_dim = 1 if reg.cost == "P2L" else 2
    if reg.disable_registration:
        return RegistrationResult(
            guess, torch.eye(3, dtype=dtype, device=dev).expand(b, 3, 3).clone(),
            torch.ones(b, dtype=torch.bool, device=dev),
            guess.new_zeros(b), guess.new_zeros(b),
            torch.zeros(b, dtype=torch.int32, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev))

    kf_cells, kf_poses, kf_valid = _active_window(
        kf_cells, kf_poses, kf_valid, guess, cfg)
    s_kf, m_tar = kf_valid.shape[1], kf_cells.valid.shape[2]
    m_src = src.valid.shape[1]
    method = resolve_assoc_method(cfg, m_src, m_tar, s_kf, dev)
    attrs = _world_attrs(kf_cells, kf_poses, cfg)
    # the grid's bucket tables are built once a call, in the keyframes'
    # local frames (its association is `associate`, not the world form)
    buckets = build_buckets(kf_cells, cfg) if method == "grid" else None
    cos_gate = math.cos(math.radians(reg.angle_outlier_deg))
    soft_scale = soft_sqrt_info = None
    if reg.soft_constraint:
        if reg_cov_guess is None:
            reg_cov_guess = torch.eye(3, dtype=dtype, device=dev).expand(b, 3, 3)
        soft_scale = torch.sqrt(torch.clamp(
            src.valid.sum(-1).to(dtype), min=1.0))
        # sqrt information of the guess prior: chol of cov^-1
        soft_sqrt_info = torch.linalg.cholesky(_inv3(
            reg_cov_guess + 1e-9 * torch.eye(3, dtype=dtype, device=dev)))

    fmax = torch.finfo(dtype).max
    pose, prev_pose = guess, guess
    prev_score = guess.new_full((b,), fmax)
    final_cost = guess.new_full((b,), fmax)
    zeros_i = torch.zeros(b, dtype=torch.int32, device=dev)
    num_assoc, num_res, itr = zeros_i, zeros_i, zeros_i
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    failed = done
    assoc = Associations(
        torch.zeros((b, s_kf, m_src), dtype=torch.int32, device=dev),
        torch.zeros((b, s_kf, m_src), dtype=dtype, device=dev),
        torch.zeros((b, s_kf, m_src), dtype=torch.bool, device=dev))

    for it in range(reg.max_itr_association):
        if it and bool(done.all()):
            break
        # coarse-to-fine association radius (`n_scan_normal.cpp:222`); every
        # lane that is still running is on iteration it + 1
        radius = guess.new_full(
            (b,), 2.0 * reg.assoc_radius if it == 0 else reg.assoc_radius)
        with record_function("associate"):
            if buckets is not None:
                a_new = associate(kf_cells, kf_poses, kf_valid, src, pose,
                                  radius, cfg, buckets)
                tgt = _tgt_from_attrs(_gather_attrs(attrs, a_new.tar_idx),
                                      cfg)
            else:
                a_new, tgt = _associate_world(attrs, src, pose, kf_valid,
                                              radius, cfg, cos_gate, method)
        n_assoc = a_new.valid.sum((-2, -1), dtype=torch.int32)
        n_res = n_assoc * res_dim + (3 if reg.soft_constraint else 0)
        failed_new = n_res <= 1                    # (`n_scan_normal.cpp:370`)
        with record_function("lm_solve"):
            if reg.soft_constraint:
                lm_pose, lm_cost, lm_steps, lm_rel = _lm_solve(
                    pose, src, tgt, a_new, cfg, guess, soft_scale,
                    soft_sqrt_info)
            else:
                packed = lm.pack_associations(src.mean, tgt,
                                              a_new.weight * a_new.valid, cfg)
                lm_pose, lm_cost, lm_steps, lm_rel = lm.lm_solve_packed(
                    packed, pose, cfg)
        current = lm_cost
        rel_improvement = (prev_score - current) / prev_score
        # convergence rules (`n_scan_normal.cpp:134-149`), after min_itr
        check = it + 1 > reg.min_itr
        worse = check & (prev_score < current)
        conv = check & ((rel_improvement < reg.score_tolerance)
                        | (lm_rel < reg.score_tolerance) | (lm_steps == 0))
        # a lane that got worse rolls back to its previous pose
        live, live_v = ~done, (~done)[:, None]
        pose = torch.where(live_v, torch.where(worse[:, None], prev_pose,
                                               lm_pose), pose)
        prev_pose = torch.where(live_v & ~(worse | conv)[:, None], lm_pose,
                                prev_pose)
        prev_score = torch.where(live & ~(worse | conv), current, prev_score)
        final_cost = torch.where(live & ~worse, current, final_cost)
        num_assoc = torch.where(live, n_assoc, num_assoc)
        num_res = torch.where(live, n_res, num_res)
        itr = torch.where(live, itr + 1, itr)
        failed = torch.where(live, failed_new, failed)
        lv = live[:, None, None]
        assoc = Associations(*(torch.where(lv, n, o)
                               for n, o in zip(a_new, assoc)))
        done = done | worse | conv | failed_new

    # --- covariance: Censi-style scaled inverse GN Hessian ---------------
    # (`n_scan_normal.cpp:392-433`) at the final pose, on the associations
    # of the last executed iteration
    tgt = _tgt_from_attrs(_gather_attrs(attrs, assoc.tar_idx), cfg)
    cost_f, _, H = _cost_grad_hess(pose, src, tgt, assoc, cfg, guess,
                                   soft_scale, soft_sqrt_info)
    dof = torch.clamp(num_res.to(dtype) - 3.0, min=1.0)
    Hinv = _inv3(H + 1e-9 * torch.eye(3, dtype=dtype, device=dev))
    cov = reg.covariance_scaler * (cost_f / dof)[:, None, None] * Hinv
    score = final_cost / torch.clamp(num_res.to(dtype), min=1.0)
    # divergence-as-failure (`min_assoc_fraction` / `max_score`)
    possible = torch.clamp(src.valid.sum(-1) * kf_valid.sum(-1), min=1
                           ).to(dtype)
    collapsed = num_assoc.to(dtype) / possible < reg.min_assoc_fraction
    if math.isfinite(reg.max_score):
        collapsed = collapsed | (score > reg.max_score)
    return RegistrationResult(
        pose=pose, cov=cov, success=~failed & ~collapsed, score=score,
        final_cost=final_cost, num_assoc=num_assoc, iterations=itr)


def is_consistent(pose, guess, max_distance: float = 1.0,
                  max_angle_deg: float = 5.0):
    """Consistency gate of registration results (..., 3) against their
    guesses (`IsConsistent`, `registration_srv_node.cpp:131-142`): the
    discrepancy T_guess^-1 T_pose within both limits."""
    d = se2.relative(guess, pose)
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    ang = torch.rad2deg(se2.normalize_angle(d[..., 2])).abs()
    return (dist <= max_distance) & (ang <= max_angle_deg)


def register_scans_service(scans: CellMap, poses, cfg,
                           consistency_max_distance: float = 1.0,
                           consistency_max_angle_deg: float = 5.0):
    """"Registration as a service" (`registration_srv_node.cpp:242-313`):
    per lane, the newest of N scans (leaves (B, N, M, ...), poses (B, N, 3))
    registered against the rest, and gated on consistency with its initial
    pose. Returns (RegistrationResult, consistent (B,))."""
    kf = CellMap(*(a[:, :-1] for a in scans))
    src = CellMap(*(a[:, -1] for a in scans))
    valid = torch.ones(poses.shape[:1] + (poses.shape[1] - 1,),
                       dtype=torch.bool, device=poses.device)
    res = register(kf, poses[:, :-1], valid, src, poses[:, -1], cfg=cfg)
    ok = res.success & is_consistent(res.pose, poses[:, -1],
                                     consistency_max_distance,
                                     consistency_max_angle_deg)
    return res, ok


def register_time_continuous(kf_cells: CellMap, kf_poses, kf_valid,
                             src: CellMap, guess, tvel, ccw: bool,
                             cfg=None) -> RegistrationResult:
    """Time-continuous variant (`RegisterTimeContinuous`,
    `n_scan_normal.cpp:67-80`): each source cell pre-warped by the fixed
    velocity tvel (B, 3) at its relative scan time, then the ordinary
    solve."""
    return register(kf_cells, kf_poses, kf_valid,
                    compensate_cells(src, tvel, ccw), guess, cfg=cfg)


def get_cost(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap, src_pose,
             cfg, attrs=None):
    """The association cost at fixed poses, no solve (`GetCost`,
    `n_scan_normal.cpp:188-213`): associate at `assoc_radius` through the
    backend `register` would use (`resolve_assoc_method`: kernels A or C on
    a card), then the robust cost. Pass `attrs` from `_world_attrs` to
    evaluate many poses against one packed window. Returns (cost (B,),
    number of residual scalars (B,) int32)."""
    reg = cfg.registration
    check_supported(cfg)
    method = resolve_assoc_method(cfg, src.valid.shape[1],
                                  kf_cells.valid.shape[2], kf_valid.shape[1],
                                  src_pose.device)
    if attrs is None:
        attrs = _world_attrs(kf_cells, kf_poses, cfg)
    radius = src_pose.new_full((src_pose.shape[0],), reg.assoc_radius)
    if method == "grid":
        assoc = associate(kf_cells, kf_poses, kf_valid, src, src_pose,
                          radius, cfg)
        tgt = _tgt_from_attrs(_gather_attrs(attrs, assoc.tar_idx), cfg)
    else:
        assoc, tgt = _associate_world(
            attrs, src, src_pose, kf_valid, radius, cfg,
            math.cos(math.radians(reg.angle_outlier_deg)), method)
    res_dim = 1 if reg.cost == "P2L" else 2
    return (_cost_only(src_pose, src, tgt, assoc, cfg),
            assoc.valid.sum((-2, -1), dtype=torch.int32) * res_dim)


def _cost_at_offsets(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap,
                     pose, offs, cfg, max_lanes: int | None = None):
    """`get_cost` at pose (B, 3) + each of offs (K, 3), as B*K lanes of one
    association pass (the window is packed once and broadcast over the
    offsets; at most `max_lanes` lanes per pass). Returns (costs (B, K),
    n_res (B, K))."""
    b, k = pose.shape[0], offs.shape[0]
    attrs = _world_attrs(kf_cells, kf_poses, cfg)
    step = k if max_lanes is None else max(1, max_lanes // b)
    costs, n_res = [], []
    for lo in range(0, k, step):
        o = offs[lo:lo + step]
        n = o.shape[0]

        def fold(a):    # (B, ...) -> (B * n, ...), each lane repeated n times
            return a[:, None].expand((b, n) + a.shape[1:]).reshape(
                (b * n,) + a.shape[1:])

        c, r = get_cost(CellMap(*(fold(a) for a in kf_cells)),
                        fold(kf_poses), fold(kf_valid),
                        CellMap(*(fold(a) for a in src)),
                        (pose[:, None] + o[None]).reshape(b * n, 3), cfg,
                        attrs=fold(attrs))
        costs.append(c.reshape(b, n))
        n_res.append(r.reshape(b, n))
    return torch.cat(costs, 1), torch.cat(n_res, 1)


def _sampling_offsets(cfg, dtype, device):
    """The k^3 (x, y, yaw) offsets of `sample_covariance`, in the
    reference's meshgrid order."""
    odo = cfg.odometry
    k = odo.cov_sampling_samples_per_axis
    xy = torch.linspace(-odo.cov_sampling_xy_range * 0.5,
                        odo.cov_sampling_xy_range * 0.5, k,
                        dtype=dtype, device=device)
    th = torch.linspace(-odo.cov_sampling_yaw_range * 0.5,
                        odo.cov_sampling_yaw_range * 0.5, k,
                        dtype=dtype, device=device)
    gx, gy, gt = torch.meshgrid(xy, xy, th, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gt.reshape(-1)], -1)


def sample_covariance(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap,
                      pose, cfg):
    """Covariance by cost sampling around the registration optimum
    (`approximateCovarianceBySampling`, `odometrykeyframefuser.cpp:261-380`):
    the cost on a k^3 grid of (x, y, yaw) offsets, a 10-coefficient
    quadratic fitted by least squares, its constant Hessian H, and where H
    is positive definite cov = 2 H^-1 * final_cost / (n_res - 3) * scaler.
    The window is gated at `pose` and packed once; the k^3 offsets of every
    lane are one association pass over B*k^3 lanes. The fit, `eigvalsh`
    and the inverse run in float64 in `torch.linalg`. Returns (cov (B, 3,
    3), convex (B,))."""
    odo = cfg.odometry
    dtype = pose.dtype
    offs = _sampling_offsets(cfg, dtype, pose.device)
    kf_cells, kf_poses, kf_valid = _active_window(kf_cells, kf_poses,
                                                  kf_valid, pose, cfg)
    costs, n_res = _cost_at_offsets(kf_cells, kf_poses, kf_valid, src, pose,
                                    offs, cfg)
    o = offs.to(torch.float64)
    x, y, t = o[:, 0], o[:, 1], o[:, 2]
    A = torch.stack([x * x, y * y, t * t, x * y, y * t, t * x, x, y, t,
                     torch.ones_like(x)], -1)                     # (K, 10)
    coef = torch.linalg.lstsq(A.expand((pose.shape[0],) + A.shape),
                              costs.to(torch.float64)[..., None]
                              ).solution[..., 0]                  # (B, 10)
    c = coef.unbind(-1)
    H = torch.stack([torch.stack([2 * c[0], c[3], c[5]], -1),
                     torch.stack([c[3], 2 * c[1], c[4]], -1),
                     torch.stack([c[5], c[4], 2 * c[2]], -1)], -2)
    convex = (torch.linalg.eigvalsh(H) > 0.0).all(-1)
    # the score scale comes from the centre sample
    centre = int(torch.argmin((offs * offs).sum(-1)))
    dof = torch.clamp(n_res[:, centre].to(torch.float64) - 3.0, min=1.0)
    eye = torch.eye(3, dtype=torch.float64, device=pose.device)
    cov = 2.0 * torch.linalg.inv(H + (~convex).to(H.dtype)[:, None, None]
                                 * eye) \
        * (costs[:, centre].to(torch.float64) / dof)[:, None, None] \
        * odo.cov_sampling_covariance_scaler
    return cov.to(dtype), convex


# lanes per association pass of `cost_surface` with the dense form, whose
# (lanes, S, Msrc, M) distance matrix is materialised, or the grid, whose
# bucket tables and candidate rows are
_DENSE_ELEMENTS = 1 << 26


def cost_surface(kf_cells: CellMap, kf_poses, kf_valid, src: CellMap, pose,
                 cfg, width: float = 5.0, res: float = 0.25):
    """The registration cost on an (x, y) grid around each lane's pose
    (`GetSurface`, `n_scan_normal.cpp:29-65`). The grid's poses are folded
    into the lane axis over the window packed once (in passes of bounded
    size where the dense form materialises its distances). Returns
    (surface (B, P, P), extent) with P = 2 ceil(width / res) + 1."""
    p = 2 * int(math.ceil(width / res)) + 1
    offs = torch.linspace(-width, width, p, dtype=pose.dtype,
                          device=pose.device)
    gx, gy = torch.meshgrid(offs, offs, indexing="xy")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.zeros_like(gx.reshape(-1))], -1)
    method = resolve_assoc_method(cfg, src.valid.shape[1],
                                  kf_cells.valid.shape[2], kf_valid.shape[1],
                                  pose.device)
    max_lanes = None
    s_kf, m_src = kf_valid.shape[1], src.valid.shape[1]
    if method == "dense":
        per_lane = s_kf * m_src * kf_cells.valid.shape[2]
        max_lanes = max(1, _DENSE_ELEMENTS // per_lane)
    elif method == "grid":     # the bucket tables and the candidate rows
        _, g = _bucket_geometry(cfg)
        cap = cfg.registration.bucket_capacity
        per_lane = s_kf * (g * g * cap + m_src * 9 * cap * 3)
        max_lanes = max(1, _DENSE_ELEMENTS // per_lane)
    costs, _ = _cost_at_offsets(kf_cells, kf_poses, kf_valid, src, pose,
                                grid, cfg, max_lanes)
    return costs.reshape(pose.shape[0], p, p), (-width, width, -width, width)


def refine_many_to_many(cells: CellMap, poses, valid, cfg, fixed_mask=None,
                        outer_iters: int = 4, gn_iters: int = 8,
                        cg_iters: int = 24, pairs_per_scan: int | None = None):
    """Joint refinement of all scan poses ("many_to_many_refinement",
    `registration.h:48`): cells (S, M, ...), poses (S, 3), valid (S,).
    Each source scan j is paired with its `pairs_per_scan` (default
    min(S-1, 8)) nearest valid targets i by initial pose-origin distance
    (a stable sort, as the reference's); each pair's residuals depend on
    both poses. Per outer iteration: exact dense 1-NN of every pair, then
    `gn_iters` Gauss-Newton steps, each solved by `cg_iters` CG iterations
    over the normal equations, the first pose (or `fixed_mask`) fixed.
    Returns the refined (S, 3) poses."""
    reg = cfg.registration
    s = poses.shape[0]
    dev = poses.device
    if fixed_mask is None:
        fixed_mask = torch.arange(s, device=dev) == 0
    free = ~fixed_mask
    k = pairs_per_scan if pairs_per_scan else min(s - 1, 8)
    inf = float("inf")

    # static pair selection from the initial poses
    dxy = poses[None, :, :2] - poses[:, None, :2]
    d0 = torch.sqrt((dxy * dxy).sum(-1))
    d0 = torch.where(valid[:, None] & valid[None, :], d0,
                     d0.new_full((), inf))
    d0 = torch.where(torch.eye(s, dtype=torch.bool, device=dev),
                     d0.new_full((), inf), d0)
    order = torch.argsort(d0, dim=0, stable=True)            # per source j
    ii = order[:k, :].T.reshape(-1)                           # targets
    jj = torch.arange(s, device=dev).repeat_interleave(k)     # sources
    pair_ok = torch.isfinite(d0[ii, jj]) & valid[ii] & valid[jj]
    cos_gate = math.cos(math.radians(reg.angle_outlier_deg))

    def take(a, idx):    # a (P, M, ...), idx (P, M) -> (P, M, ...)
        flat = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(
            idx.shape + a.shape[2:])
        return torch.gather(a, 1, flat)

    def pair_assoc(cur):
        """Exact dense 1-NN of each source's cells into its target's frame."""
        t_rel = se2.relative(cur[ii], cur[jj])                 # (P, 3)
        src_t = se2.transform(t_rel, cells.mean[jj])           # (P, M, 2)
        src_n = se2.rotate(t_rel, cells.normal[jj])
        tar = cells.mean[ii]
        d2 = ((src_t ** 2).sum(-1)[:, :, None] + (tar ** 2).sum(-1)[:, None]
              - 2.0 * torch.matmul(src_t, tar.transpose(1, 2)))
        d2 = torch.where(cells.valid[ii][:, None, :], d2, d2.new_full((), inf))
        nn = torch.argmin(d2, dim=2)
        nn_d2 = torch.gather(d2, 2, nn[..., None])[..., 0]
        sim_dir = torch.clamp((src_n * take(cells.normal[ii], nn)).sum(-1),
                              min=0.0)
        ok = (cells.valid[jj] & pair_ok[:, None]
              & (nn_d2 < reg.assoc_radius ** 2) & (sim_dir > cos_gate))
        w = losses.association_weight(
            reg.weight_opt, cells.nsamples[jj], take(cells.nsamples[ii], nn),
            sim_dir, cells.planarity[jj], take(cells.planarity[ii], nn))
        return nn, torch.where(ok, w, torch.zeros_like(w))

    def residuals(p, tar_idx, w_a):
        src_w = se2.transform(p[jj], cells.mean[jj])           # (P, M, 2)
        tar_w = se2.transform(p[ii], take(cells.mean[ii], tar_idx))
        d = src_w - tar_w
        if reg.cost == "P2L":
            n_w = se2.rotate(p[ii], take(cells.normal[ii], tar_idx))
            e = (d * n_w).sum(-1, keepdim=True)
        else:
            e = d
        _, drho = losses.rho((e * e).sum(-1), reg.loss, reg.loss_limit)
        # IRLS: the robust weight is a constant within a GN step
        return e * torch.sqrt(w_a * drho).detach()[..., None]

    def proj(x):
        return torch.where(free[:, None], x, torch.zeros_like(x))

    def gn_step(p, tar_idx, w_a):
        def f(q):
            return residuals(q, tar_idx, w_a)

        r, vjp_fn = torch.func.vjp(f, p)
        (grad,) = vjp_fn(r)

        def hvp(x):
            x = proj(x)
            _, jv = torch.func.jvp(f, (p,), (x,))
            return proj(vjp_fn(jv)[0]) + 1e-6 * x

        b = -proj(grad)
        x, rr, pp, rs = torch.zeros_like(b), b, b, (b * b).sum()
        for _ in range(cg_iters):
            ap = hvp(pp)
            denom = (pp * ap).sum()
            alpha = rs / torch.where(denom > 0, denom, torch.ones_like(denom))
            x = x + alpha * pp
            rr = rr - alpha * ap
            rs_new = (rr * rr).sum()
            pp = rr + (rs_new / torch.where(rs > 0, rs, torch.ones_like(rs))
                       ) * pp
            rs = rs_new
        return p + proj(x)

    cur = poses
    for _ in range(outer_iters):
        tar_idx, w_a = pair_assoc(cur)
        for _ in range(gn_iters):
            cur = gn_step(cur, tar_idx, w_a)
    return cur
