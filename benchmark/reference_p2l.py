"""Plain reference of keyframe radar odometry with the point-to-line cost
(CFEAR-2), for the benchmark's check of what the program produced.

`reference.py` with its registration's cost replaced, nothing else: the
filter, the motion compensation, the oriented surface points, the exact
nearest neighbour, the gates, the weights, the keyframe ring and the
following of the program are that file's (see its docstring). It imports
numpy and torch through it and reads every parameter from the
configuration file's `params`. A configuration names it with
`"reference": "reference_p2l.py"`; `Odometry.check` then takes
`registration.cost` "P2L" and refuses every other cost.

The point-to-line cost (Adolfsson et al., IEEE T-RO 2023, the cost of
CFEAR-2 in Tab. I): each association of a source cell s (frame coordinates) to a
target cell with mean m and unit normal n (both moved into the anchor
frame by the keyframe's pose) gives one residual, the distance of the
moved source mean to the target's line,

    e = n . (R(theta) s + t - m),

with the Jacobian [n_x, n_y, n . dR(theta)/dtheta s], and the cost
0.5 sum w rho(e^2) over the associations, w the association's weight and
rho the configured robust loss of the squared residual. The solve is
`reference.py`'s trust-region Levenberg-Marquardt over these rows, in
float64.

Departures from the paper's description, each the program's upstream
rule where the paper gives none:
- a frame fails where it has one residual or none (n_assoc <= 1: the
  upstream `n_res <= 1` with one residual an association; P2P's two
  residuals an association make that rule `2 n_assoc <= 1` in
  `reference.py`);
- the residual is taken in the anchor frame (the newest keyframe's), with
  every keyframe's means and normals moved there once, where the paper
  moves the source into each keyframe's frame: the same distances;
- the normal gate, the association weights, the outer loop's stop rules
  and the LM's trust-region schedule are `reference.py`'s (the upstream
  code's and Ceres' defaults), which the paper does not state.
"""

from __future__ import annotations

import math

import torch

from benchmark import reference
from benchmark.reference import (cells, compensate, nearest, points, rotate,
                                 transform)

__all__ = ["Registration", "Odometry", "PARAMS", "points", "compensate",
           "cells", "transform", "rotate", "nearest"]

PARAMS = {**reference.PARAMS, "registration.cost": (("P2L",), "")}


class Registration(reference.Registration):
    """Registration of each lane's frame cells to its keyframe window by the
    point-to-line cost."""

    def _lm(self, sx, sy, tx, ty, nx, ny, w, pose):
        """Trust-region LM over point-to-line rows (L, N) from pose (L, 3),
        float64: source mean (sx, sy), target mean (tx, ty) and normal
        (nx, ny) in the anchor frame, weight w. Returns (pose, cost,
        accepted steps, last relative decrease)."""
        reg = self.reg
        loss, lim = reg["loss"], reg["loss_limit"]

        def residual(p):
            c = torch.cos(p[:, 2])[:, None]
            s = torch.sin(p[:, 2])[:, None]
            e = (nx * (c * sx - s * sy + p[:, 0, None] - tx)
                 + ny * (s * sx + c * sy + p[:, 1, None] - ty))
            return c, s, e

        def cost_only(p):
            _, _, e = residual(p)
            return 0.5 * (w * reference._robust(e * e, loss, lim)[0]).sum(-1)

        def cgh(p):
            c, s, e = residual(p)
            rho, drho = reference._robust(e * e, loss, lim)
            wd = w * drho
            jac = torch.stack([nx, ny, nx * (-s * sx - c * sy)
                               + ny * (c * sx - s * sy)], -1)   # (L, N, 3)
            g = torch.einsum("ln,ln,lnp->lp", wd, e, jac)
            h = torch.einsum("ln,lnp,lnq->lpq", wd, jac, jac)
            return 0.5 * (w * rho).sum(-1), g, h

        n_lanes = pose.shape[0]
        dev = pose.device
        cost, g, h = cgh(pose)
        radius = torch.full((n_lanes,), 1e4, dtype=torch.float64, device=dev)
        dec = torch.full_like(radius, 2.0)
        steps = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
        last = torch.full_like(radius, math.inf)
        done = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
        ftol = reg["function_tolerance"]
        for _ in range(reg["max_itr_solver"]):
            if bool(done.all()):
                break
            diag = torch.clamp(torch.diagonal(h, dim1=1, dim2=2), 1e-6, 1e32)
            step = -torch.linalg.solve(h + torch.diag_embed(diag
                                                             / radius[:, None]),
                                       g)
            new = pose + step
            new_cost = cost_only(new)
            model = -((g * step).sum(-1)
                      + 0.5 * (step * (h @ step[..., None])[..., 0]).sum(-1))
            rel = (cost - new_cost) / torch.clamp(model, min=1e-30)
            accept = (rel > 1e-3) & torch.isfinite(new_cost)
            t = 2.0 * rel - 1.0
            r_ok = radius / torch.clamp(torch.clamp(1.0 - t * t * t,
                                                    min=1.0 / 3.0), min=1e-3)
            r_bad = radius / dec
            finished = ((accept & ((cost - new_cost).abs() <= ftol * cost))
                        | (model <= ftol * cost)
                        | (step.norm(dim=-1) <= 1e-8 * (pose.norm(dim=-1)
                                                         + 1e-8))
                        | (r_bad < 1e-32))
            c2, g2, h2 = cgh(new)
            live = ~done
            take = live & accept
            pose = torch.where(take[:, None], new, pose)
            cost = torch.where(take, c2, cost)
            g = torch.where(take[:, None], g2, g)
            h = torch.where(take[:, None, None], h2, h)
            radius = torch.where(live, torch.where(
                accept, torch.clamp(r_ok, max=1e16), r_bad), radius)
            dec = torch.where(live, torch.where(accept, torch.full_like(dec,
                                                                        2.0),
                                                dec * 2.0), dec)
            steps = steps + take.to(torch.int64)
            last = torch.where(live, rel, last)
            done = done | finished
        return pose, cost, steps, last

    def __call__(self, kf, kf_pose, kf_valid, src, guess):
        """kf: cell dict (L, S, M, ...), kf_pose (L, S, 3) f64 in the
        anchor frame, kf_valid (L, S), src: cell dict (L, Ms, ...), guess
        (L, 3) f64. Returns (pose, success, n_assoc, iterations)."""
        reg = self.reg
        n_lanes = guess.shape[0]
        dev = guess.device
        tar = transform(kf_pose, kf["mean"].double())         # (L, S, M, 2)
        tar_n = rotate(kf_pose, kf["normal"].double())
        tar_ok = kf["valid"] & kf_valid[..., None]
        cos_gate = math.cos(math.radians(reg["angle_outlier_deg"]))
        s_mean = src["mean"].double()
        pose = prev_pose = guess
        prev_score = torch.full((n_lanes,), 3.4028234663852886e38,
                                dtype=torch.float64, device=dev)
        done = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
        failed = torch.zeros_like(done)
        n_assoc = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
        iters = torch.zeros_like(n_assoc)
        for it in range(reg["max_itr_association"]):
            if it and bool(done.all()):
                break
            r0 = reg["assoc_radius"] * (2.0 if it == 0 else 1.0)
            sw = transform(pose, s_mean)                      # (L, Ms, 2)
            snw = rotate(pose, src["normal"].double())
            nn, d2 = nearest(sw, tar, tar_ok, self.precision)
            lane = torch.arange(n_lanes, device=dev)[:, None, None]
            kfi = torch.arange(tar.shape[1], device=dev)[None, :, None]
            t_mean = tar[lane, kfi, nn]                        # (L, S, Ms, 2)
            t_norm = tar_n[lane, kfi, nn]
            sim = torch.clamp((snw[:, None] * t_norm).sum(-1), min=0.0)
            ok = (src["valid"][:, None] & tar_ok[lane, kfi, nn]
                  & (d2 < r0 * r0) & (sim > cos_gate))
            w = (reference._similarity(src["nsamples"][:, None].double(),
                                       kf["nsamples"][lane, kfi, nn].double())
                 + sim + reference._similarity(
                     src["planarity"][:, None].double(),
                     kf["planarity"][lane, kfi, nn].double()))
            w = torch.where(ok, w, torch.zeros_like(w))
            count = ok.sum((1, 2))

            def rows(x):
                return x.reshape(n_lanes, -1)

            lm_pose, lm_cost, lm_steps, lm_rel = self._lm(
                rows(s_mean[:, None, :, 0].expand_as(w)),
                rows(s_mean[:, None, :, 1].expand_as(w)),
                rows(t_mean[..., 0]), rows(t_mean[..., 1]),
                rows(t_norm[..., 0]), rows(t_norm[..., 1]), rows(w), pose)
            check = it + 1 > reg["min_itr"]
            worse = check & (prev_score < lm_cost)
            conv = check & (((prev_score - lm_cost) / prev_score
                             < reg["score_tolerance"])
                            | (lm_rel < reg["score_tolerance"])
                            | (lm_steps == 0))
            live = ~done
            keep_going = live & ~(worse | conv)
            pose = torch.where(live[:, None], torch.where(
                worse[:, None], prev_pose, lm_pose), pose)
            prev_pose = torch.where(keep_going[:, None], lm_pose, prev_pose)
            prev_score = torch.where(keep_going, lm_cost, prev_score)
            n_assoc = torch.where(live, count, n_assoc)
            iters = iters + live.to(torch.int64)
            # one residual an association: a frame fails with one or none
            failed = torch.where(live, count <= 1, failed)
            done = done | worse | conv | (count <= 1)
        possible = torch.clamp(src["valid"].sum(-1) * kf_valid.sum(-1), min=1)
        collapsed = n_assoc.double() / possible.double() \
            < reg["min_assoc_fraction"]
        return pose, ~failed & ~collapsed, n_assoc, iters


class Odometry(reference.Odometry):
    """`reference.Odometry` with the point-to-line registration; it takes
    `registration.cost` "P2L" alone."""

    registration = Registration
    PARAMS = PARAMS
