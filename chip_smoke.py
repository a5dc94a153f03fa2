"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `cfear_radarodometry_code_public_tpu_torch/
csrc/` with nvcc and checks each against its plain PyTorch twin on the card:
the 1-NN kernels A and C, the fused LM solve F (both variants, three cost /
loss pairs at S=4, and at the s50 widths: S=16 and S=50 of 1024 cells, and
S=50 of 3072) and the feature-moment kernel G (on the slice's own frames).
Then it drives the CFEAR-3 host-ingest odometry slice at Oxford sensor scale
(400 x 3768 polar sweeps, k=40, point_budget 8192, max_cells 1024, S=4
keyframes, Morton-ordered cells, block-sparse association) through the
port's entry points: single-sequence (`OdometryRunner`), the preset as users
call it (`auto`: kernel A), batched x8 (`make_batched_step`, two runs that
must agree bit for bit), and single-sequence with `feature.backend="pallas"`
(kernel G). Then CFEAR-3-s50, the 50-keyframe submap, over 128 frames:
exact and with the K=16 gate (`s50`, `s50-k16`), batched x8
(`s50-batched`), and the preset as users call it (`s50-preset`), after which
C, D1, D2 and E are held against their twins on the window that path ends
with (B=1, M=3072). Last, the multi-keyframe kernels D1, D2 and the
fused-lookup kernel E run on the 50-keyframe window the `s50` path ends
with, at B=1 and B=8, and are held bit for bit against kernel C, the flat
gather and their twins (`s50-window`). Each path is held against a JAX golden
(`tools/make_torch_port_golden.py`) or the single run, and must launch the
kernels it runs (launch counts zeroed just before each path, read just
after). Exits non-zero, printing no result, when there is no CUDA card or
any phase fails. The last line of stdout is {"ok": true, "device": {...}};
the line before it lists the kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import cfear_radarodometry_code_public_tpu_torch as port
from cfear_radarodometry_code_public_tpu_torch._shared import (
    kitti, native_io, synthetic)
from cfear_radarodometry_code_public_tpu_torch.eval import ate_rmse
from cfear_radarodometry_code_public_tpu_torch.models import odometry
from cfear_radarodometry_code_public_tpu_torch.ops import (
    _build, cuda_assoc, cuda_features, cuda_lm, features, filtering,
    registration)
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap
from cfear_radarodometry_code_public_tpu_torch.utils import se2

ROOT = os.path.dirname(os.path.abspath(__file__))
_GOLDEN_DIR = os.path.join(ROOT, "cfear_radarodometry_code_public_tpu_torch",
                           "golden")
GOLDEN = os.path.join(_GOLDEN_DIR, "cfear3_oxford_seed1_64.npz")
GOLDEN_PALLAS = os.path.join(_GOLDEN_DIR,
                             "cfear3_oxford_seed1_64_pallasfeat.npz")
SEQUENCE = {"seed": 1, "n_frames": 64, "speed": 6.0}   # as bench.py renders it
# CFEAR-3-s50: bench.py's default 128 frames; at 6 m/s nearly every frame
# is a keyframe, so the 50-keyframe window is full for the last ~75 frames
S50_SEQUENCE = {"seed": 1, "n_frames": 128, "speed": 6.0}
GOLDEN_S50 = os.path.join(_GOLDEN_DIR, "cfear3s50_oxford_seed1_128.npz")
GOLDEN_S50_K16 = os.path.join(_GOLDEN_DIR, "cfear3s50k16_oxford_seed1_128.npz")
BATCH = 8
# Trajectory tolerances against the JAX-on-CPU golden and between the
# port's own runs. They differ by f32 ulps (sin/cos, sum order, XLA's FMA
# in the golden's distances), which move a few points across voxel and gate
# boundaries and flip a few accepted associations. The reference itself
# spreads as far between its own association backends: on this sequence its
# dense form and its block-sparse kernel differ by 2.18 cm per pose, 5.0e-4
# rad and 8.8 mm per frame-to-frame motion (JAX on the CPU;
# `tools/make_torch_port_golden.py --assoc-method dense` prints it). The
# tolerances are about 3x that; a wrong association rule or sign costs
# 0.1-1 m.
TOL = (0.08, 3e-3, 0.025)   # (position m, yaw rad, motion m)
# CFEAR-3-s50 against its goldens, set the same way (`... --preset
# CFEAR-3-s50 [--k-active 16] --assoc-method dense`): dense against
# block-sparse, the exact window differs by 1.68 cm per pose, 4.10e-4 rad
# and 1.68 cm per motion, K16 by 1.68 cm, 3.96e-4 rad and 1.68 cm (the
# largest position difference is on frame 1, whose pose is its motion,
# before the gate has a keyframe to drop). The limits are about 3x that.
S50_TOL = (0.05, 1.25e-3, 0.05)
# Kernel F against its twin: the tolerance of the reference's own
# kernel-vs-XLA test (tests/test_registration.py:565-567); the two sum in
# another order, which can move an accept or convergence test by an ulp.
LM_POSE_TOL, LM_COST_RTOL = 1e-4, 1e-3
LM_CASES = (("P2P", "Huber"), ("P2L", "Huber"), ("P2D", "Cauchy"))
# Kernel G against its twin: counts exact; moments (f32 sums of up to a few
# hundred terms, in point order on both sides) within 1e-4 of each row's
# largest value.
MOMENT_RTOL = 1e-4
_PKG = "cfear_radarodometry_code_public_tpu"
KERNELS = {   # name -> (TPU kernel it replaces, CUDA source)
    "nn_min": (f"{_PKG}/ops/pallas_assoc.py:48", "nn_assoc.cu"),
    "nn_min_sparse": (f"{_PKG}/ops/pallas_assoc.py:263", "nn_assoc.cu"),
    "lm_solve_fused": (f"{_PKG}/ops/pallas_lm.py:339", "lm_fused.cu"),
    "moment_accumulate": (f"{_PKG}/ops/pallas_features.py:135", "moments.cu"),
    "nn_min_sparse_multi": (f"{_PKG}/ops/pallas_assoc.py:376", "nn_assoc.cu"),
    "nn_min_sparse_unrolled": (f"{_PKG}/ops/pallas_assoc.py:479",
                               "nn_assoc.cu"),
    "nn_min_sparse_attrs": (f"{_PKG}/ops/pallas_assoc.py:591", "nn_assoc.cu"),
}


def slice_config(assoc_method: str = "pallas_sparse", spatial_sort=True,
                 feature_backend: str | None = None):
    """CFEAR-3 at Oxford scale with the bench settings (`bench.py:121-143`).
    `slice_config("auto", False)` is the preset as users call it, which
    resolves to the dense kernel A on a CUDA card;
    `slice_config(feature_backend="pallas")` takes kernel G for the
    feature moments."""
    cfg = port.preset("CFEAR-3", dataset="oxford")
    feat = dataclasses.replace(cfg.feature, point_budget=8192, max_cells=1024,
                               spatial_sort=spatial_sort)
    if feature_backend is not None:
        feat = dataclasses.replace(feat, backend=feature_backend)
    return cfg.replace(
        feature=feat,
        registration=dataclasses.replace(cfg.registration,
                                         assoc_method=assoc_method))


def s50_config(k_active: int = 0):
    """CFEAR-3-s50 at Oxford scale with the bench settings for that preset
    (`bench.py:124-143` under `--preset CFEAR-3-s50`): point_budget 8192,
    max_cells 1024, spatial_sort on, `assoc_method="pallas_sparse"` (kernel
    C); `k_active=16` is `--max-active-keyframes 16`, the K16 gate."""
    cfg = port.preset("CFEAR-3-s50", dataset="oxford")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, point_budget=8192,
                                    max_cells=1024, spatial_sort=True),
        registration=dataclasses.replace(
            cfg.registration, assoc_method="pallas_sparse",
            max_active_keyframes=k_active))


def _say(msg: str) -> None:
    print(msg, flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, n: int) -> float:
    """Mean ms per call of fn() over n calls, by CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _wall_world(rng):
    """4,800 points on 24 random 60 m walls within +-110 m."""
    walls = []
    for _ in range(24):
        p0 = rng.uniform(-110, 110, 2)
        ang = rng.uniform(0, 2 * np.pi)
        t = rng.uniform(0, 60, 200)
        walls.append(p0 + np.stack([np.cos(ang) * t, np.sin(ang) * t], -1))
    return np.concatenate(walls)


def _morton_cells(rng, b, s, m, dev):
    """Slice-shaped association inputs: per lane a wall world seen by S+1
    scans of m cells (~900 valid, Morton-ordered by 3 m voxel, padding
    last), keyframes a few metres apart. Lane 7's last keyframe is empty;
    lane 0's first keyframe holds two identical targets in different
    512-row tiles with a source point on them (an exact tie)."""
    leaf = 3.0
    src = np.zeros((b, m, 2), np.float32)
    tar = np.zeros((b, s, m, 2), np.float32)
    valid = np.zeros((b, s + 1, m), bool)
    for i in range(b):
        world = _wall_world(rng)
        for k in range(s + 1):
            n = int(rng.integers(850, 1000))
            pts = world[rng.choice(len(world), n, replace=False)]
            pts = pts + rng.normal(0, 0.3, pts.shape) + k * 1.5
            ij = np.floor(pts / leaf).astype(np.int64) + 64
            code = np.zeros(n, np.int64)
            for bit in range(8):
                code |= ((ij[:, 0] >> bit) & 1) << (2 * bit)
                code |= ((ij[:, 1] >> bit) & 1) << (2 * bit + 1)
            pts = pts[np.argsort(code, kind="stable")]
            rows = src[i] if k == 0 else tar[i, k - 1]
            rows[:n] = pts
            valid[i, k, :n] = True
    valid[7, s] = False
    tar[0, 0, 700] = tar[0, 0, 300]
    valid[0, 1, [300, 700]] = True
    src[0, 5] = tar[0, 0, 300]
    to = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    return to(src), to(valid[:, 0]), to(tar), to(valid[:, 1:])


def phase_kernels(dev, card):
    """Kernels A and C against their plain twins at the slice's shapes."""
    b, s, m = BATCH, 4, 1024
    src, src_valid, tar, valid = _morton_cells(np.random.default_rng(0),
                                               b, s, m, dev)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    _say(f"build: {len(_build.SOURCES)} sources, nvcc in parallel, then "
         f"link: {build_s:.2f} s ({card})")
    for line in (_build.build_info.get("cmd") or "cached").splitlines():
        _say(f"  {line}")
    for line in _build.build_info.get("report", "").splitlines():
        _say(f"  ptxas: {line}")
    res = {}
    nn_a, d2_a = cuda_assoc.nn_min(src, tar, valid)
    nn_p, d2_p = cuda_assoc.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    if not (torch.equal(nn_a, nn_p) and torch.equal(d2_a, d2_p)):
        raise AssertionError("kernel A disagrees with nn_min_plain: "
                             f"{int((nn_a != nn_p).sum())} nn mismatches")
    if nn_a[0, 0, 5].item() != 300:
        raise AssertionError("kernel A: tie not resolved to the lowest index")
    if not torch.isinf(d2_a[7, s - 1]).all():
        raise AssertionError("kernel A: empty keyframe must give +inf")
    fin = torch.isfinite(d2_p)
    res["nn_min"] = {
        "max_abs_err": float((d2_a[fin] - d2_p[fin]).abs().max()),
        "ms": _cuda_ms(lambda: cuda_assoc.nn_min(src, tar, valid), 200),
        "plain_ms": _cuda_ms(lambda: cuda_assoc.nn_min_plain(src, tar, valid),
                             20)}
    sb = cuda_assoc.tile_bounds(src, src_valid, cuda_assoc.TS_SPARSE)
    tb = cuda_assoc.tile_bounds(tar, valid, cuda_assoc.TT_SPARSE)
    errs, times, ptimes = [], [], []
    for r in (2.0, 4.0):
        radius = torch.full((b,), r, device=dev)
        nn_c, d2_c = cuda_assoc.nn_min_sparse(src, sb, tar, tb, valid, radius)
        nn_q, d2_q = cuda_assoc.nn_min_sparse_plain(src, sb, tar, tb, valid,
                                                    radius)
        torch.cuda.synchronize()
        if not (torch.equal(nn_c, nn_q) and torch.equal(d2_c, d2_q)):
            raise AssertionError(f"kernel C (r={r}) disagrees with "
                                 "nn_min_sparse_plain")
        within = d2_p <= r * r
        if not (torch.equal(nn_c[within], nn_p[within])
                and torch.equal(d2_c[within], d2_p[within])):
            raise AssertionError(f"kernel C (r={r}) differs from A within "
                                 "the radius")
        if not (d2_c[~within] >= r * r).all():
            raise AssertionError(f"kernel C (r={r}): a row beyond the radius "
                                 "reports d2 < r^2")
        fin = torch.isfinite(d2_q)
        errs.append(float((d2_c[fin] - d2_q[fin]).abs().max()))
        times.append(_cuda_ms(lambda: cuda_assoc.nn_min_sparse(
            src, sb, tar, tb, valid, radius), 200))
        ptimes.append(_cuda_ms(lambda: cuda_assoc.nn_min_sparse_plain(
            src, sb, tar, tb, valid, radius), 20))
        _say(f"kernel C r={r}: rows within radius "
             f"{float(within.float().mean()):.3f}, kernel {times[-1]:.4f} ms, "
             f"plain {ptimes[-1]:.4f} ms ({card})")
    res["nn_min_sparse"] = {"max_abs_err": max(errs),
                            "ms": float(np.mean(times)),
                            "plain_ms": float(np.mean(ptimes))}
    _say(f"kernel A: nn equal, d2 bit-equal; kernel {res['nn_min']['ms']:.4f}"
         f" ms, plain {res['nn_min']['plain_ms']:.4f} ms at B={b} S={s} "
         f"M={m} ({card})")
    _say("kernel C: nn equal, d2 bit-equal to its twin and to A within the "
         "radius, d2 >= r^2 beyond it")
    return res


def lm_problem(rng, b, s, m, cost, loss):
    """`b` packed LM problems shaped like the slice's associations: per lane
    m source cells on a wall world (88% valid), each seen in s keyframes
    with 0.15 m noise and 8% gross outliers, weights 0.3-2 with 15% of the
    associations dropped, random unit normals (P2L) and random sqrt-
    information (P2D). Returns (cfg, packed (b, 8, s*m), pose0 (b, 3),
    true pose (b, 3)) as numpy f32; pose0 is the true pose perturbed by
    ~0.3 m / 0.02 rad."""
    cfg = slice_config()
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, cost=cost, loss=loss))
    n_ok = int(0.88 * m)
    src = np.zeros((b, m, 2))
    for i in range(b):
        world = _wall_world(rng)
        src[i, :n_ok] = (world[rng.choice(len(world), n_ok, replace=False)]
                         + rng.normal(0, 0.3, (n_ok, 2)))
    true = rng.uniform(-1, 1, (b, 3)) * np.array([1.5, 0.5, 0.05])
    c, sn = np.cos(true[:, 2])[:, None], np.sin(true[:, 2])[:, None]
    moved = np.stack([c * src[..., 0] - sn * src[..., 1] + true[:, :1],
                      sn * src[..., 0] + c * src[..., 1] + true[:, 1:2]], -1)
    tgt = moved[:, None] + rng.normal(0, 0.15, (b, s, m, 2))
    out = rng.random((b, s, m)) < 0.08
    tgt[out] += rng.uniform(-4, 4, (int(out.sum()), 2))
    w = rng.uniform(0.3, 2.0, (b, s, m)) * (rng.random((b, s, m)) < 0.85)
    w[..., n_ok:] = 0.0
    if cost == "P2L":
        ang = rng.uniform(0, 2 * np.pi, (b, s, m))
        r5, r6, r7 = np.cos(ang), np.sin(ang), np.zeros((b, s, m))
    elif cost == "P2D":
        r5, r6, r7 = (rng.uniform(0.5, 2, (b, s, m)), rng.normal(0, 0.3, (b, s, m)),
                      rng.uniform(0.5, 2, (b, s, m)))
    else:
        r5, r6, r7 = np.ones((b, s, m)), np.zeros((b, s, m)), np.ones((b, s, m))
    sx = np.broadcast_to(src[:, None, :, 0], (b, s, m))
    sy = np.broadcast_to(src[:, None, :, 1], (b, s, m))
    packed = np.stack([a.reshape(b, s * m) for a in
                       (sx, sy, tgt[..., 0], tgt[..., 1], w, r5, r6, r7)], 1)
    pose0 = true + rng.normal(0, 1, (b, 3)) * np.array([0.3, 0.3, 0.02])
    f32 = np.float32
    return cfg, packed.astype(f32), pose0.astype(f32), true.astype(f32)


def _lm_case(rng, dev, card, s, cost, loss, n=100, m=1024):
    """Kernel F, both variants, on `lm_problem(rng, BATCH, s, m, cost,
    loss)` against its plain twin. Returns (|dpose|, early-exit ms, plain
    ms)."""
    cfg, packed, pose0, true = lm_problem(rng, BATCH, s, m, cost, loss)
    packed, pose0 = (torch.as_tensor(a).to(dev) for a in (packed, pose0))
    ee = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=True)
    masked = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=False)
    plain = cuda_lm.lm_solve_fused_plain(packed, pose0, cfg)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(ee, masked)):
        raise AssertionError(f"kernel F {cost}/{loss}: early exit and "
                             "masked variants differ")
    dpose = float((ee[0] - plain[0]).abs().max())
    dcost = float(((ee[1] - plain[1]).abs() / plain[1].abs()).max())
    if not (np.isfinite(dpose) and dpose <= LM_POSE_TOL
            and dcost <= LM_COST_RTOL):
        raise AssertionError(
            f"kernel F {cost}/{loss} disagrees with its twin: pose "
            f"{dpose:.3e} (tol {LM_POSE_TOL}), cost rel {dcost:.3e} "
            f"(tol {LM_COST_RTOL})")
    off = float((ee[0].cpu() - torch.as_tensor(true)).abs().max())
    t_ee = _cuda_ms(lambda: cuda_lm.lm_solve_fused(packed, pose0, cfg), n)
    t_m = _cuda_ms(lambda: cuda_lm.lm_solve_fused(
        packed, pose0, cfg, early_exit=False), n)
    t_p = _cuda_ms(lambda: cuda_lm.lm_solve_fused_plain(packed, pose0, cfg),
                   10)
    _say(f"kernel F {cost}/{loss}: early exit == masked bit for bit; vs "
         f"twin |dpose| {dpose:.3e}, cost rel {dcost:.3e}; steps kernel "
         f"{ee[2].tolist()} twin {plain[2].tolist()}; max |pose - true| "
         f"{off:.4f}; early exit {t_ee:.4f} ms, masked {t_m:.4f} ms, "
         f"plain {t_p:.4f} ms at B={BATCH} N={packed.shape[2]} ({card})")
    return dpose, t_ee, t_p


def phase_lm(dev, card):
    """Kernel F, both variants, against its plain twin at the slice's width
    (B=8 lanes, N = 4 keyframes x 1024 cells, three cost/loss pairs) and at
    the s50 widths (P2P/Cauchy, N = 16 and 50 keyframes x 1024 cells: the
    K16 and the exact window; and 50 x 3072 cells, N = 153,600: the
    `s50-preset` window)."""
    rng = np.random.default_rng(1)
    rows = [_lm_case(rng, dev, card, 4, cost, loss)
            for cost, loss in LM_CASES]
    rows += [_lm_case(rng, dev, card, s, "P2P", "Cauchy", n=20, m=m)
             for s, m in ((16, 1024), (50, 1024), (50, 3072))]
    return {"lm_solve_fused": {"max_abs_err": max(r[0] for r in rows),
                               "ms": rows[0][1], "plain_ms": rows[0][2]}}


def phase_moments(images, dev, card):
    """Kernel G against its plain twin on the slice's first 8 frames as 8
    lanes (N = 8192 points, c_pre = 4608 cells), and two launches
    bit-identical."""
    cfg = slice_config(feature_backend="pallas")
    rows = odometry.host_filter(images[:BATCH], cfg, "compact")
    pts = filtering.points_from_compact(odometry.to_device(rows, dev), cfg)
    inputs = features._moment_inputs(pts, cfg)
    pack, ct_lo, ct_hi, pt_lo, pt_hi, _, _, c_pre = inputs
    k1 = cuda_features.moment_accumulate(*inputs)
    k2 = cuda_features.moment_accumulate(*inputs)
    plain = cuda_features.moment_accumulate_plain(*inputs)
    torch.cuda.synchronize()
    if not torch.equal(k1, k2):
        raise AssertionError("kernel G: two launches differ")
    if not torch.equal(k1[:, 0], plain[:, 0]):
        raise AssertionError("kernel G: counts differ from the twin")
    if k1[:, 9:].abs().max() != 0:
        raise AssertionError("kernel G: padding rows are not zero")
    err_abs, err_rel = 0.0, 0.0
    for r in range(1, 9):
        d = float((k1[:, r] - plain[:, r]).abs().max())
        err_abs = max(err_abs, d)
        err_rel = max(err_rel, d / max(float(plain[:, r].abs().max()), 1e-30))
    if not err_rel <= MOMENT_RTOL:
        raise AssertionError(f"kernel G: moments differ from the twin by "
                             f"{err_rel:.3e} of the row scale (tol "
                             f"{MOMENT_RTOL})")
    live = ((ct_lo[:, :, None] <= pt_hi[:, None, :])
            & (ct_hi[:, :, None] >= pt_lo[:, None, :])).float().mean()
    occupied = (plain[:, 0] > 0).sum(-1).tolist()
    ms = _cuda_ms(lambda: cuda_features.moment_accumulate(*inputs), 50)
    plain_ms = _cuda_ms(lambda: cuda_features.moment_accumulate_plain(*inputs),
                        5)
    _say(f"kernel G: pack {tuple(pack.shape)}, c_pre {c_pre}, cells with "
         f"points per lane {occupied}, live (cell tile, point tile) pairs "
         f"{float(live):.3f}; counts exact, moments within {err_rel:.3e} of "
         f"the row scale ({err_abs:.3e} abs), two launches bit-identical; "
         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
    return {"moment_accumulate": {"max_abs_err": err_abs, "ms": ms,
                                  "plain_ms": plain_ms}}


def traj_spread(got, want):
    """(max |dpos| m, max |dyaw| rad, max |dmotion| m) between two (N, 3)
    trajectories; a motion is the frame-to-frame step in the earlier
    pose's frame."""
    def motions(t):
        d = t[1:] - t[:-1]
        c, s = np.cos(t[:-1, 2]), np.sin(t[:-1, 2])
        return np.stack([c * d[:, 0] + s * d[:, 1],
                         -s * d[:, 0] + c * d[:, 1]], -1)

    return (float(np.abs(got[:, :2] - want[:, :2]).max()),
            float(np.abs(got[:, 2] - want[:, 2]).max()),
            float(np.abs(motions(got) - motions(want)).max()))


def _check_traj(name, got, want, fused, fused_want, tol=TOL):
    dpos, dyaw, dmot = traj_spread(got, want)
    _say(f"{name}: max |dpos| {dpos:.6f} m, |dyaw| {dyaw:.3e} rad, "
         f"|dmotion| {dmot:.6f} m; fused flags equal: "
         f"{bool(np.array_equal(fused, fused_want))}")
    if not np.array_equal(fused, fused_want):
        raise AssertionError(f"{name}: keyframe decisions differ at frames "
                             f"{np.flatnonzero(fused != fused_want).tolist()}")
    if dpos > tol[0] or dyaw > tol[1] or dmot > tol[2]:
        raise AssertionError(f"{name}: trajectory outside tolerance "
                             f"({tol[0]} m, {tol[1]} rad, {tol[2]} m)")
    return dpos


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_single(cfg, images, dev):
    """Two passes of OdometryRunner over the frames; returns the runner of
    the second and both wall times."""
    runner = odometry.OdometryRunner(cfg, ingest="host", device=dev, chunk=16)
    secs = []
    for rep in range(2):
        if rep:
            runner.reset()
        t0 = time.perf_counter()
        runner.process(images)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    return runner, secs


def _report(name, traj, out, gt, secs, card, g_ate):
    """Print a path's frames/s, ATE, drift and counts; fail when its ATE is
    more than 5 cm worse than the golden's `g_ate`."""
    n = traj.shape[0]
    _say(f"{name}: {n} frames, first pass {n / secs[0]:.2f} "
         f"frames/s (warm-up included), second pass {n / secs[1]:.2f} "
         f"frames/s, host filter included ({card})")
    ate = ate_rmse(traj[:, :2], gt[:, :2])
    drift = kitti.kitti_drift(traj, gt, step_size=5, lengths=(50.0,))
    _say(f"{name}: ATE {ate:.4f} m (golden {g_ate:.4f} m), drift "
         f"{drift['t_err_percent']:.3f}% over 50 m, keyframes "
         f"{int(out.fused.sum())}, mean cells {out.num_cells.mean():.1f}, "
         f"mean assoc {out.num_assoc[1:].mean():.1f}")
    if ate > g_ate + 0.05:
        raise AssertionError(f"{name}: ATE {ate} m worse than the golden's "
                             f"{g_ate} m")


def phase_single(cfg, images, gt, dev, card, golden, name="single",
                 tol=TOL, full_window=False):
    """One sequence through OdometryRunner, held against a JAX golden.
    With `full_window`, the run must end with every keyframe slot valid.
    Returns (trajectory, frame outputs, final state)."""
    n = images.shape[0]
    runner, secs = _run_single(cfg, images, dev)
    traj, out = runner.trajectory(), runner.frame_outputs()
    with np.load(golden) as z:
        if json.loads(str(z["config"])) != cfg.to_dict():
            raise AssertionError("golden was made for another configuration")
        g_traj, g_fused, g_ate = z["poses"], z["fused"], float(z["ate"])
    if not np.isfinite(traj).all() or traj.shape != (n, 3):
        raise AssertionError("trajectory not finite or of the wrong shape")
    if not out.success.all():
        raise AssertionError(f"failed frames {np.flatnonzero(~out.success)}")
    _check_traj(f"{name} vs JAX golden", traj, g_traj, out.fused, g_fused,
                tol)
    _report(name, traj, out, gt, secs, card, g_ate)
    n_kf = int(runner.state.kf_valid.sum())
    _say(f"{name}: {n_kf} of {cfg.odometry.submap_scan_size} keyframe slots "
         "valid at the end")
    if full_window and n_kf != cfg.odometry.submap_scan_size:
        raise AssertionError(f"{name}: the keyframe window is not full")
    return traj, out, runner.state


def phase_auto(images, traj, out, dev, card):
    """The preset as users call it (assoc 'auto', no spatial sort): on a
    card it resolves to kernel A; held against the kernel-C run."""
    n = images.shape[0]
    runner, secs = _run_single(slice_config("auto", spatial_sort=False),
                               images, dev)
    traj_a, out_a = runner.trajectory(), runner.frame_outputs()
    if not out_a.success.all():
        raise AssertionError("auto (kernel A) run has failed frames")
    _check_traj("auto (kernel A) vs pallas_sparse (kernel C)", traj_a, traj,
                out_a.fused, out.fused)
    _say(f"auto (kernel A): {n / secs[1]:.2f} frames/s ({card})")


def phase_batched(cfg, images, traj, out, dev, card, batch=BATCH, tol=TOL):
    """make_batched_step over `batch` lanes fed the same frames, twice;
    every lane held against the single-sequence run."""
    n = images.shape[0]
    rows = odometry.host_filter(images, cfg, "compact")
    staged = odometry.to_device(odometry.filtering.CompactCandidates(
        *(np.broadcast_to(a[:, None], (n, batch) + a.shape[1:])
          for a in rows)), dev)
    boot = odometry.make_bootstrap(cfg, batched=True)
    step = odometry.make_batched_step(cfg)

    def run():
        states = odometry.init_state(cfg, dev, batch=batch)
        states, o = boot(states, odometry._map(lambda a: a[0], staged))
        outs = [o]
        for t in range(1, n):
            states, o = step(states, odometry._map(lambda a: a[t], staged))
            outs.append(o)
        return odometry.FrameOutput(*(torch.stack(x, 1).cpu().numpy()
                                      for x in zip(*outs)))

    trajs, secs = [], []
    for rep in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        res = run()
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        trajs.append([odometry.compose_trajectory(
            odometry.FrameOutput(*(a[i] for a in res))) for i in range(batch)])
        dev_lane = []
        for i in range(batch):
            if not res.success[i].all():
                raise AssertionError(f"batched lane {i} has failed frames")
            dev_lane.append(_check_traj(f"batched lane {i} vs single",
                                        trajs[-1][i], traj, res.fused[i],
                                        out.fused, tol))
        _say(f"batched run {rep + 1}: largest |dpos| of each lane from the "
             f"single run (m): {[f'{d:.6f}' for d in dev_lane]}")
    bitwise = all(np.array_equal(a, b) for a, b in zip(*trajs))
    _say(f"batched x{batch}: {batch * n / secs[0]:.2f} and "
         f"{batch * n / secs[1]:.2f} frames/s per card over two runs "
         f"(inputs pre-staged on the card; {card}); trajectories "
         f"bit-identical across the two runs: {bitwise}")
    if not bitwise:
        raise AssertionError("two batched runs of the same frames gave "
                             "different trajectories")


def phase_s50_preset(images, gt, dev, card):
    """CFEAR-3-s50 as users call it (max_cells 3072, no point budget:
    candidates ingest; `auto`, which resolves to kernel C on a card) over
    the s50 sequence: every frame must succeed, and the ATE must be within
    5 cm of the exact golden's (it has no golden of its own). Returns the
    configuration and the final state."""
    cfg = port.preset("CFEAR-3-s50", dataset="oxford")
    m = cfg.feature.max_cells
    method = registration.resolve_assoc_method(
        cfg, m, m, cfg.odometry.submap_scan_size, dev)
    if method != "pallas_sparse":
        raise AssertionError(f"s50-preset: auto resolved to {method}")
    runner, secs = _run_single(cfg, images, dev)
    if runner.kind != "candidates":
        raise AssertionError("s50-preset: expected the candidates ingest")
    traj, out = runner.trajectory(), runner.frame_outputs()
    if not np.isfinite(traj).all() or not out.success.all():
        raise AssertionError("s50-preset: failed or non-finite frames "
                             f"{np.flatnonzero(~out.success)}")
    with np.load(GOLDEN_S50) as z:
        g_ate = float(z["ate"])
    _report(f"s50-preset (max_cells {m}, auto -> kernel C)", traj, out, gt,
            secs, card, g_ate)
    return cfg, runner.state


def _lanes(a, b):
    """(1, ...) -> (b, ...): one lane broadcast over b, contiguous."""
    return a.expand((b,) + a.shape[1:]).contiguous()


def window_inputs(state, cfg, dev, name="s50 window", lanes=(1, BATCH)):
    """The real keyframe window that an s50 run ends with, built as the
    reference's TPU probe builds it (`tools/profile_s50.py:72-117`): the
    source is the newest keyframe's cells in the world frame at its pose;
    the targets are the window's `_world_attrs`; bounds by `tile_bounds`;
    the radius is `assoc_radius`. Returns {B: (args, attrs_t, attrs)} for
    each lane count B in `lanes` (the window broadcast over B lanes), where
    args = (src, src_bounds, tar, tar_bounds, valid, radius) and attrs_t
    (B, S, D_pad, M) is attrs (B, S, M, D) transposed and zero-padded."""
    kf = CellMap(*(a[None] for a in state.kf_cells))
    kf_poses, kf_valid = state.kf_poses[None], state.kf_valid[None]
    attrs = registration._world_attrs(kf, kf_poses, cfg)     # (1, S, M, D)
    src_w = se2.transform(kf_poses[:, -1], kf.mean[:, -1])
    _, s, m, d = attrs.shape
    d_pad = 8 if d <= 8 else 16
    attrs_t = attrs.new_zeros((1, s, d_pad, m))
    attrs_t[:, :, :d] = attrs.transpose(-1, -2)
    tar_valid = (attrs[..., 6] > 0.5) & kf_valid[..., None]
    r = cfg.registration.assoc_radius
    _say(f"{name}: S={s}, valid keyframes {int(kf_valid.sum())}, mean "
         f"valid cells {float(kf.valid.float().sum(-1).mean()):.1f}, M={m}, "
         f"D={d} (D_pad {d_pad}), radius {r} m")
    win = {}
    for b in lanes:
        src, tar, valid = (_lanes(a, b) for a in (src_w, attrs[..., 0:2],
                                                  tar_valid))
        sb = cuda_assoc.tile_bounds(src, _lanes(kf.valid[:, -1], b),
                                    cuda_assoc.TS_SPARSE).contiguous()
        tb = cuda_assoc.tile_bounds(tar, valid,
                                    cuda_assoc.TT_SPARSE).contiguous()
        radius = torch.full((b,), r, device=dev)
        win[b] = ((src, sb, tar, tb, valid, radius), _lanes(attrs_t, b),
                  _lanes(attrs, b))
    return win


def _window_calls(args, at):
    """name -> a call of one association kernel on the window."""
    return {
        "nn_min_sparse": lambda: cuda_assoc.nn_min_sparse(*args),
        "nn_min_sparse_multi": lambda: cuda_assoc.nn_min_sparse_multi(*args),
        "nn_min_sparse_unrolled":
            lambda: cuda_assoc.nn_min_sparse_unrolled(*args),
        "nn_min_sparse_attrs":
            lambda: cuda_assoc.nn_min_sparse_attrs(*args[:5], at, args[5])}


def drive_window(win):
    """Kernels C, D1, D2 and E once each on the window at every lane count,
    as the reference's probe drives them; returns their outputs by B."""
    outs = {b: {k: f() for k, f in _window_calls(args, at).items()}
            for b, (args, at, _) in win.items()}
    torch.cuda.synchronize()
    return outs


def phase_window(win, outs, r, card, name="s50 window"):
    """The window's outputs (`drive_window`) checked: at every lane count C
    equals its twin, D1 and D2 equal C bit for bit, E's (nn, d2) equal C's,
    its g equals its twin's and the flat gather (`_gather_attrs`) on every
    row within the radius and is zero on +inf rows and in the padding.
    Times by CUDA events: C, D1, D2, E, the gather, C + gather, and the
    twins. Returns {B: records of D1, D2 and E}; every check is bit for
    bit, so each max_abs_err is 0.0."""
    res = {}
    for b, (args, at, att) in win.items():
        o = outs[b]
        nn_c, d2_c = o["nn_min_sparse"]
        nn_p, d2_p = cuda_assoc.nn_min_sparse_plain(*args)
        _, _, g_p = cuda_assoc.nn_min_sparse_attrs_plain(*args[:5], at, args[5])
        gathered = registration._gather_attrs(att, nn_c)
        torch.cuda.synchronize()
        if not (torch.equal(nn_c, nn_p) and torch.equal(d2_c, d2_p)):
            raise AssertionError(f"{name} B={b}: kernel C differs from its "
                                 "twin")
        for k, (nn, d2, *_) in o.items():
            if not (torch.equal(nn, nn_c) and torch.equal(d2, d2_c)):
                raise AssertionError(f"{name} B={b}: {k} (nn, d2) differ from "
                                     "kernel C's")
        g_e = o["nn_min_sparse_attrs"][2]
        if not torch.equal(g_e, g_p):
            raise AssertionError(f"{name} B={b}: kernel E's g differs from its twin")
        d = att.shape[-1]
        within, inf = d2_c <= r * r, torch.isinf(d2_c)
        g_rows = g_e.transpose(-1, -2)                     # (B, S, Msrc, D_pad)
        if not torch.equal(g_rows[..., :d][within], gathered[within]):
            raise AssertionError(f"{name} B={b}: kernel E's g differs from the flat "
                                 "gather within the radius")
        if (g_rows[inf] != 0).any() or (g_rows[..., d:] != 0).any():
            raise AssertionError(f"{name} B={b}: kernel E's g is not zero on +inf "
                                 "rows or padding")
        live = float(cuda_assoc.pair_live(args[1], args[3], args[5])
                     .float().mean())
        t = {k: _cuda_ms(f, 50) for k, f in _window_calls(args, at).items()}
        t["gather"] = _cuda_ms(lambda: registration._gather_attrs(att, nn_c),
                               50)
        t["C + gather"] = _cuda_ms(lambda: registration._gather_attrs(
            att, cuda_assoc.nn_min_sparse(*args)[0]), 50)
        t["plain"] = _cuda_ms(lambda: cuda_assoc.nn_min_sparse_plain(*args), 5)
        t["plain E"] = _cuda_ms(lambda: cuda_assoc.nn_min_sparse_attrs_plain(
            *args[:5], at, args[5]), 5)
        _say(f"{name} B={b}: executed tile pairs {live:.4f}, rows within "
             f"the radius {float(within.float().mean()):.4f}, +inf rows "
             f"{float(inf.float().mean()):.4f}; D1, D2 == C == twin bit for "
             f"bit, E (nn, d2) == C, E g == gather within r, 0 on +inf rows")
        _say(f"{name} B={b} (ms, CUDA events; {card}): "
             + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
        res[b] = {k: {"max_abs_err": 0.0, "ms": t[k], "plain_ms":
                      t["plain E" if k.endswith("attrs") else "plain"]}
                  for k in ("nn_min_sparse_multi", "nn_min_sparse_unrolled",
                            "nn_min_sparse_attrs")}
    return res


def _reset_launches() -> None:
    for mod in (cuda_assoc, cuda_lm, cuda_features):
        mod.reset_launches()


def _launches() -> dict:
    return {**cuda_assoc.launches, **cuda_lm.launches, **cuda_features.launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = _card()
    _say(card)
    _say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
         f"native host filter: {native_io.native_available()}")
    kernels = phase_kernels(dev, card)
    kernels.update(phase_lm(dev, card))

    cfg = slice_config()
    t0 = time.perf_counter()
    images, gt = synthetic.make_sequence(cfg=cfg, **SEQUENCE)
    _say(f"rendered {images.shape} in {time.perf_counter() - t0:.1f} s")
    kernels.update(phase_moments(images, dev, card))

    # the paths: each one's launches are counted from zero just before it
    paths: dict = {}

    def drive(name, needs, fn):
        _reset_launches()
        result = fn()
        paths[name] = _launches()
        _say(f"launches in the {name} path: {paths[name]}")
        for k in needs:
            if paths[name][k] == 0:
                raise AssertionError(f"the {name} path never launched {k}")
        return result

    traj, out, _ = drive(
        "single", ("nn_min_sparse", "lm_solve_fused"),
        lambda: phase_single(cfg, images, gt, dev, card, GOLDEN))
    drive("auto", ("nn_min", "lm_solve_fused"),
          lambda: phase_auto(images, traj, out, dev, card))
    drive("batched", ("nn_min_sparse", "lm_solve_fused"),
          lambda: phase_batched(cfg, images, traj, out, dev, card))
    drive("pallas-features",
          ("moment_accumulate", "nn_min_sparse", "lm_solve_fused"),
          lambda: phase_single(slice_config(feature_backend="pallas"), images,
                               gt, dev, card, GOLDEN_PALLAS,
                               "pallas-features"))

    s50 = s50_config()
    t0 = time.perf_counter()
    images50, gt50 = synthetic.make_sequence(cfg=s50, **S50_SEQUENCE)
    _say(f"rendered {images50.shape} in {time.perf_counter() - t0:.1f} s")
    traj50, out50, state50 = drive(
        "s50", ("nn_min_sparse", "lm_solve_fused"),
        lambda: phase_single(s50, images50, gt50, dev, card, GOLDEN_S50,
                             "s50", S50_TOL, full_window=True))
    drive("s50-k16", ("nn_min_sparse", "lm_solve_fused"),
          lambda: phase_single(s50_config(16), images50, gt50, dev, card,
                               GOLDEN_S50_K16, "s50-k16", S50_TOL,
                               full_window=True))
    drive("s50-batched", ("nn_min_sparse", "lm_solve_fused"),
          lambda: phase_batched(s50, images50, traj50, out50, dev, card,
                                tol=S50_TOL))
    preset, state_p = drive("s50-preset", ("nn_min_sparse", "lm_solve_fused"),
                            lambda: phase_s50_preset(images50, gt50, dev, card))
    # kernel C at the preset's shapes (B=1, S=50, Msrc=M=3072) against its
    # twin on the window that path ends with, and D1, D2, E beside it
    win_p = window_inputs(state_p, preset, dev, "s50-preset window", (1,))
    phase_window(win_p, drive_window(win_p),
                 preset.registration.assoc_radius, card, "s50-preset window")
    # D1, D2 and E on the window the s50 path ends with: the counted run is
    # one call of each; the checks against C and the twins, and the
    # timings, come after the counts are read
    win = window_inputs(state50, s50, dev)
    outs = drive("s50-window", ("nn_min_sparse", "nn_min_sparse_multi",
                                "nn_min_sparse_unrolled",
                                "nn_min_sparse_attrs"),
                 lambda: drive_window(win))
    # the kernels line keeps the s50 window's B=8 times
    kernels.update(phase_window(win, outs, s50.registration.assoc_radius,
                                card)[BATCH])
    launches = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    _say(f"kernel launches in the main-path runs: {launches}")

    csrc = os.path.relpath(os.path.dirname(_build.SOURCES[0]), ROOT)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"{csrc}/{src}",
         "replaces": tpu, "launches": launches[name], **kernels[name]}
        for name, (tpu, src) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
