"""Scan-to-multi-keyframe registration (port of `ops/registration.py`,
main path only).

Batched over a leading lane axis (B = 1 is the single sequence): the newest
scan of each lane is registered against that lane's S keyframes; only its
pose is free. Outer association loop (at most `max_itr_association`
iterations): world-frame attributes packed once, exact 1-NN association
(CUDA kernels A/C or the dense matmul form), gates and weights, then the
packed LM solve (`lm.lm_solve_packed`: CUDA kernel F on a card, one launch
per solve; the plain loop on the CPU). The reference's `while_loop` becomes
a fixed-trip loop in which a finished lane keeps its state, with an early
stop once every lane is done. Afterwards the Censi-scaled covariance.

Not ported yet (raise NotImplementedError): `soft_constraint`,
`time_continuous`, `assoc_method="grid"`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc, lm, losses
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap
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
    """Raise for registration settings the port does not run yet."""
    reg = cfg.registration
    if reg.soft_constraint:
        raise NotImplementedError(
            "registration.soft_constraint is not ported yet (ROADMAP queue 1, "
            "item 11: the einsum LM with the guess prior)")
    if reg.time_continuous:
        raise NotImplementedError(
            "registration.time_continuous is not ported yet (ROADMAP queue 1, "
            "item 11: register_time_continuous)")
    if reg.assoc_method == "grid":
        raise NotImplementedError(
            "registration.assoc_method='grid' is not ported (ROADMAP queue 1, "
            "item 11: a parity ablation ~400x slower than the kernels)")
    if reg.assoc_method not in ("auto",) + _FAST_DENSE:
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


def _cost_grad_hess(pose, src, tgt, assoc: Associations, cfg):
    """Total robust cost (B,), gradient (B, 3) and IRLS Gauss-Newton
    Hessian (B, 3, 3)."""
    reg = cfg.registration
    r, J = _residuals(pose, src, tgt, cfg)
    s = (r * r).sum(-1)
    rho_s, drho = losses.rho(s, reg.loss, reg.loss_limit)
    w = assoc.weight * assoc.valid
    cost = 0.5 * (w * rho_s).sum((-2, -1))
    wd = w * drho
    g = torch.einsum("bsm,bsmdp,bsmd->bp", wd, J, r)
    H = torch.einsum("bsm,bsmdp,bsmdq->bpq", wd, J, J)
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
             cfg=None) -> RegistrationResult:
    """Register each lane's newest scan against its S keyframes.

    kf_cells leaves (B, S, M, ...) in their local frames, kf_poses (B, S, 3)
    FIXED poses, kf_valid (B, S), src leaves (B, M, ...) in its local frame,
    guess (B, 3)."""
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
    cos_gate = math.cos(math.radians(reg.angle_outlier_deg))

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
            a_new, tgt = _associate_world(attrs, src, pose, kf_valid, radius,
                                          cfg, cos_gate, method)
        n_assoc = a_new.valid.sum((-2, -1), dtype=torch.int32)
        n_res = n_assoc * res_dim
        failed_new = n_res <= 1                    # (`n_scan_normal.cpp:370`)
        with record_function("lm_solve"):
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
    cost_f, _, H = _cost_grad_hess(pose, src, tgt, assoc, cfg)
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
