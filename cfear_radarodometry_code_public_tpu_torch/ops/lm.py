"""The inner trust-region Levenberg-Marquardt solve over packed rows
(port of the non-kernel half of `ops/pallas_lm.py`: `pack_associations`,
`_lm_funcs`, `_lm_core`, `lm_solve_packed_xla`).

`lm_solve_packed` is the one entry point: on a CUDA card it launches kernel
F (`ops/cuda_lm.py`, one launch per solve for all lanes, no host sync); on
the CPU it runs `_lm_core`, the plain loop. That loop is batched over a
leading lane axis: the reference's data-dependent `while_loop` becomes a
fixed-trip loop of `max_itr_solver` iterations in which a lane that is done
keeps its state (the reference's `bounded` form, identical results), and it
stops early once every lane is done.

Row layout of the packed (B, 8, N) block, N = S*M:
  P2P / P2D: [sx, sy, mx, my, w, l11, l21, l22]   (l* = sqrt-info; 1/0 for P2P)
  P2L:       [sx, sy, mx, my, w, nx, ny, 0]
The reference pads N to a multiple of 128 for the TPU's lane tiling; zero
rows add nothing, so the port does not pad.
"""

from __future__ import annotations

import torch

from cfear_radarodometry_code_public_tpu_torch.ops import cuda_lm, losses
from cfear_radarodometry_code_public_tpu_torch.utils import trace


def pack_associations(src_mean, tgt, assoc_weight, cfg):
    """src_mean (B, M, 2), tgt terms (B, S, M, .), weight (B, S, M) ->
    (B, 8, S*M) packed rows. Invalid associations carry weight 0."""
    cost = cfg.registration.cost
    b, s, m = assoc_weight.shape
    n = s * m

    def flat(x):
        return x.reshape(b, n)

    sx = flat(src_mean[:, None, :, 0].expand(b, s, m))
    sy = flat(src_mean[:, None, :, 1].expand(b, s, m))
    w = flat(assoc_weight)
    if cost == "P2L":
        r5, r6 = flat(tgt["normal"][..., 0]), flat(tgt["normal"][..., 1])
        r7 = torch.zeros_like(w)
    elif cost == "P2D":
        si = tgt["sqrt_info"]
        r5, r6, r7 = flat(si[..., 0]), flat(si[..., 1]), flat(si[..., 2])
    else:  # P2P: identity sqrt-info
        r5, r6, r7 = torch.ones_like(w), torch.zeros_like(w), torch.ones_like(w)
    return torch.stack([sx, sy, flat(tgt["mean"][..., 0]),
                        flat(tgt["mean"][..., 1]), w, r5, r6, r7], 1)


def _lm_funcs(rows, cfg):
    """(cgh, body) closures over packed rows (each (B, N));
    poses, costs and LM scalars are (B,) tensors."""
    reg = cfg.registration
    sx, sy, mx, my, w, r5, r6, r7 = rows

    def residuals(px, py, pt):
        c, s = torch.cos(pt)[:, None], torch.sin(pt)[:, None]
        tx = c * sx - s * sy + px[:, None]
        ty = s * sx + c * sy + py[:, None]
        return c, s, tx - mx, ty - my

    def cgh(px, py, pt):
        """cost, g (3 x (B,)), H (6 upper entries) at the pose."""
        c, s, dx, dy = residuals(px, py, pt)
        jx = -s * sx - c * sy           # d(tx)/dtheta
        jy = c * sx - s * sy            # d(ty)/dtheta
        if reg.cost == "P2L":
            e = dx * r5 + dy * r6
            rho, drho = losses.rho(e * e, reg.loss, reg.loss_limit)
            wd = w * drho
            jt = r5 * jx + r6 * jy
            cost = 0.5 * (w * rho).sum(-1)
            g = ((wd * r5 * e).sum(-1), (wd * r6 * e).sum(-1),
                 (wd * jt * e).sum(-1))
            h = ((wd * r5 * r5).sum(-1), (wd * r5 * r6).sum(-1),
                 (wd * r5 * jt).sum(-1), (wd * r6 * r6).sum(-1),
                 (wd * r6 * jt).sum(-1), (wd * jt * jt).sum(-1))
        else:
            e0 = r5 * dx
            e1 = r6 * dx + r7 * dy
            rho, drho = losses.rho(e0 * e0 + e1 * e1, reg.loss, reg.loss_limit)
            wd = w * drho
            j0t = r5 * jx
            j1t = r6 * jx + r7 * jy
            cost = 0.5 * (w * rho).sum(-1)
            g = ((wd * (r5 * e0 + r6 * e1)).sum(-1), (wd * (r7 * e1)).sum(-1),
                 (wd * (j0t * e0 + j1t * e1)).sum(-1))
            h = ((wd * (r5 * r5 + r6 * r6)).sum(-1), (wd * (r6 * r7)).sum(-1),
                 (wd * (r5 * j0t + r6 * j1t)).sum(-1),
                 (wd * (r7 * r7)).sum(-1), (wd * (r7 * j1t)).sum(-1),
                 (wd * (j0t * j0t + j1t * j1t)).sum(-1))
        return cost, g, h

    def cost_only(px, py, pt):
        _, _, dx, dy = residuals(px, py, pt)
        if reg.cost == "P2L":
            e = dx * r5 + dy * r6
            ssq = e * e
        else:
            e0 = r5 * dx
            e1 = r6 * dx + r7 * dy
            ssq = e0 * e0 + e1 * e1
        rho, _ = losses.rho(ssq, reg.loss, reg.loss_limit)
        return 0.5 * (w * rho).sum(-1)

    def solve3(h, g):
        hxx, hxy, hxt, hyy, hyt, htt = h
        c00 = hyy * htt - hyt * hyt
        c01 = hxt * hyt - hxy * htt
        c02 = hxy * hyt - hxt * hyy
        c11 = hxx * htt - hxt * hxt
        c12 = hxy * hxt - hxx * hyt
        c22 = hxx * hyy - hxy * hxy
        det = hxx * c00 + hxy * c01 + hxt * c02
        inv_det = losses._rdiv(1.0, torch.where(det.abs() > 1e-30, det,
                                                det.new_full((), 1e-30)))
        dx = (c00 * g[0] + c01 * g[1] + c02 * g[2]) * inv_det
        dy = (c01 * g[0] + c11 * g[1] + c12 * g[2]) * inv_det
        dt = (c02 * g[0] + c12 * g[1] + c22 * g[2]) * inv_det
        return dx, dy, dt

    def body(carry):
        (px, py, pt, cost, g, h, radius, dec, itr, steps, lastrel, done) = carry
        hxx, hxy, hxt, hyy, hyt, htt = h
        dxx = torch.clamp(hxx, 1e-6, 1e32) / radius
        dyy = torch.clamp(hyy, 1e-6, 1e32) / radius
        dtt = torch.clamp(htt, 1e-6, 1e32) / radius
        hlm = (hxx + dxx, hxy, hxt, hyy + dyy, hyt, htt + dtt)
        sx_, sy_, st_ = solve3(hlm, (-g[0], -g[1], -g[2]))
        npx, npy, npt = px + sx_, py + sy_, pt + st_
        new_cost = cost_only(npx, npy, npt)
        gd = g[0] * sx_ + g[1] * sy_ + g[2] * st_
        hd0 = hxx * sx_ + hxy * sy_ + hxt * st_
        hd1 = hxy * sx_ + hyy * sy_ + hyt * st_
        hd2 = hxt * sx_ + hyt * sy_ + htt * st_
        model_red = -(gd + 0.5 * (sx_ * hd0 + sy_ * hd1 + st_ * hd2))
        rel = (cost - new_cost) / torch.clamp(model_red, min=1e-30)
        accept = (rel > 1e-3) & torch.isfinite(new_cost)
        t = 2.0 * rel - 1.0
        shrink = 1.0 - t * t * t
        r_ok = radius / torch.clamp(torch.clamp(shrink, min=1.0 / 3.0), min=1e-3)
        r_bad = radius / dec
        func_conv = (cost - new_cost).abs() <= reg.function_tolerance * cost
        pred_conv = model_red <= reg.function_tolerance * cost
        stepn = torch.sqrt(sx_ * sx_ + sy_ * sy_ + st_ * st_)
        posen = torch.sqrt(px * px + py * py + pt * pt)
        step_small = stepn <= 1e-8 * (posen + 1e-8)
        new_done = (accept & func_conv) | pred_conv | step_small | (r_bad < 1e-32)
        spx = torch.where(accept, npx, px)
        spy = torch.where(accept, npy, py)
        spt = torch.where(accept, npt, pt)
        cost2, g2, h2 = cgh(spx, spy, spt)
        cost2 = torch.where(accept, cost2, cost)
        g2 = tuple(torch.where(accept, a, b) for a, b in zip(g2, g))
        h2 = tuple(torch.where(accept, a, b) for a, b in zip(h2, h))
        return (spx, spy, spt, cost2, g2, h2,
                torch.where(accept, torch.clamp(r_ok, max=1e16), r_bad),
                torch.where(accept, torch.full_like(dec, 2.0), dec * 2.0),
                itr + 1, steps + accept.to(torch.int32), rel, new_done)

    return cgh, body


def _freeze(done, old, new):
    """Per-lane select over nested tuples: keep `old` where `done`."""
    if isinstance(old, tuple):
        return tuple(_freeze(done, o, n) for o, n in zip(old, new))
    return torch.where(done, old, new)


def _lm_core(rows, px0, py0, pt0, cfg):
    """The LM loop over packed rows (each (B, N)) from poses (B,).
    Returns (px, py, pt, cost, steps, last_rel), each (B,)."""
    reg = cfg.registration
    cgh, body = _lm_funcs(rows, cfg)
    cost0, g0, h0 = cgh(px0, py0, pt0)
    b = px0.shape[0]

    def full(v, dtype=torch.float32):
        return torch.full((b,), v, dtype=dtype, device=px0.device)

    carry = (px0, py0, pt0, cost0, g0, h0, full(1e4), full(2.0),
             full(0, torch.int32), full(0, torch.int32), full(float("inf")),
             full(False, torch.bool))
    for _ in range(reg.max_itr_solver):
        done = carry[11]
        if trace.item("sync.lm", done.all()):
            break
        carry = _freeze(done, carry, body(carry))
    px, py, pt, cost, _, _, _, _, _, steps, lastrel, _ = carry
    return px, py, pt, cost, steps, lastrel


def lm_solve_packed(packed, pose0, cfg):
    """packed (B, 8, N), pose0 (B, 3) -> (pose (B, 3), cost (B,),
    steps (B,) int32, last_rel (B,)): kernel F (early exit) for CUDA
    tensors, the plain loop for CPU tensors."""
    pose, cost, steps, lastrel = cuda_lm.lm_solve_fused(
        packed.to(torch.float32).contiguous(),
        pose0.to(torch.float32).contiguous(), cfg, early_exit=True)
    return pose.to(pose0.dtype), cost, steps, lastrel
