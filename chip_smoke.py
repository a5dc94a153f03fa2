"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `cfear_radarodometry_code_public_tpu_torch/
csrc/` with nvcc, checks each against its plain PyTorch twin on the card,
then drives the CFEAR-3 host-ingest odometry slice at Oxford sensor scale
(400 x 3768 polar sweeps, k=40, point_budget 8192, max_cells 1024, S=4
keyframes, Morton-ordered cells, block-sparse association) through the
port's entry points, single-sequence (`OdometryRunner`) and batched x8
(`make_batched_step`), and holds the trajectory against a JAX golden
(`tools/make_torch_port_golden.py`). Exits non-zero, printing no result,
when there is no CUDA card or any phase fails. The last line of stdout is
{"ok": true, "device": {...}}; the line before it lists the kernels.
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
from cfear_radarodometry_code_public_tpu_torch.ops import _build, cuda_assoc

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "cfear_radarodometry_code_public_tpu_torch",
                      "golden", "cfear3_oxford_seed1_64.npz")
SEQUENCE = {"seed": 1, "n_frames": 64, "speed": 6.0}   # as bench.py renders it
BATCH = 8
# Trajectory tolerances against the JAX-on-CPU golden and between the
# port's own runs. They differ by f32 ulps (sin/cos, sum order, float
# atomics in index_add_, XLA's FMA in the golden's distances), which move a
# few points across voxel and gate boundaries and flip a few accepted
# associations. The reference itself spreads as far between its own
# association backends: on this sequence its dense form and its
# block-sparse kernel differ by 2.7 cm per pose and 8.6 mm per
# frame-to-frame motion (JAX on the CPU). The tolerances are about 3x that;
# a wrong association rule or sign costs 0.1-1 m.
POS_TOL, YAW_TOL, MOTION_TOL = 0.08, 3e-3, 0.025
KERNELS = {
    "nn_min": "cfear_radarodometry_code_public_tpu/ops/pallas_assoc.py:48",
    "nn_min_sparse": "cfear_radarodometry_code_public_tpu/ops/pallas_assoc.py:263",
}


def slice_config(assoc_method: str = "pallas_sparse", spatial_sort=True):
    """CFEAR-3 at Oxford scale with the bench settings (`bench.py:121-143`).
    `slice_config("auto", False)` is the preset as users call it, which
    resolves to the dense kernel A on a CUDA card."""
    cfg = port.preset("CFEAR-3", dataset="oxford")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, point_budget=8192,
                                    max_cells=1024, spatial_sort=spatial_sort),
        registration=dataclasses.replace(cfg.registration,
                                         assoc_method=assoc_method))


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
        walls = []
        for _ in range(24):
            p0 = rng.uniform(-110, 110, 2)
            ang = rng.uniform(0, 2 * np.pi)
            t = rng.uniform(0, 60, 200)
            walls.append(p0 + np.stack([np.cos(ang) * t, np.sin(ang) * t], -1))
        world = np.concatenate(walls)
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
    _say(f"build: nvcc {_build.build_info.get('cmd')} -> "
         f"{build_s:.2f} s ({card})")
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


def _check_traj(name, got, want, fused, fused_want):
    dpos = float(np.abs(got[:, :2] - want[:, :2]).max())
    dyaw = float(np.abs(got[:, 2] - want[:, 2]).max())

    def motions(t):
        d = t[1:] - t[:-1]
        c, s = np.cos(t[:-1, 2]), np.sin(t[:-1, 2])
        return np.stack([c * d[:, 0] + s * d[:, 1],
                         -s * d[:, 0] + c * d[:, 1]], -1)

    dmot = float(np.abs(motions(got) - motions(want)).max())
    _say(f"{name}: max |dpos| {dpos:.6f} m, |dyaw| {dyaw:.3e} rad, "
         f"|dmotion| {dmot:.6f} m; fused flags equal: "
         f"{bool(np.array_equal(fused, fused_want))}")
    if not np.array_equal(fused, fused_want):
        raise AssertionError(f"{name}: keyframe decisions differ at frames "
                             f"{np.flatnonzero(fused != fused_want).tolist()}")
    if dpos > POS_TOL or dyaw > YAW_TOL or dmot > MOTION_TOL:
        raise AssertionError(f"{name}: trajectory outside tolerance "
                             f"({POS_TOL} m, {YAW_TOL} rad, {MOTION_TOL} m)")


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


def phase_single(cfg, images, gt, dev, card, golden):
    """The single-sequence slice, held against the JAX golden."""
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
    _check_traj("single vs JAX golden", traj, g_traj, out.fused, g_fused)
    ate = ate_rmse(traj[:, :2], gt[:, :2])
    drift = kitti.kitti_drift(traj, gt, step_size=5, lengths=(50.0,))
    _say(f"single-sequence: {n} frames, first pass {n / secs[0]:.2f} "
         f"frames/s (warm-up included), second pass {n / secs[1]:.2f} "
         f"frames/s, host filter included ({card})")
    _say(f"single-sequence: ATE {ate:.4f} m (golden {g_ate:.4f} m), drift "
         f"{drift['t_err_percent']:.3f}% over 50 m, keyframes "
         f"{int(out.fused.sum())}, mean cells {out.num_cells.mean():.1f}, "
         f"mean assoc {out.num_assoc[1:].mean():.1f}")
    if ate > g_ate + 0.05:
        raise AssertionError(f"ATE {ate} m worse than the golden's {g_ate} m")
    return traj, out


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


def phase_batched(cfg, images, traj, out, dev, card, batch=BATCH):
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
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        res = run()
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        trajs.append([odometry.compose_trajectory(
            odometry.FrameOutput(*(a[i] for a in res))) for i in range(batch)])
        for i in range(batch):
            if not res.success[i].all():
                raise AssertionError(f"batched lane {i} has failed frames")
            _check_traj(f"batched lane {i} vs single", trajs[-1][i], traj,
                        res.fused[i], out.fused)
    bitwise = all(np.array_equal(a, b) for a, b in zip(*trajs))
    _say(f"batched x{batch}: {batch * n / secs[0]:.2f} and "
         f"{batch * n / secs[1]:.2f} frames/s per card over two runs "
         f"(inputs pre-staged on the card; {card}); trajectories "
         f"bit-identical across the two runs: {bitwise}")


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

    cfg = slice_config()
    t0 = time.perf_counter()
    images, gt = synthetic.make_sequence(cfg=cfg, **SEQUENCE)
    _say(f"rendered {images.shape} in {time.perf_counter() - t0:.1f} s")
    # the main path: every launch from here on counts
    cuda_assoc.reset_launches()
    traj, out = phase_single(cfg, images, gt, dev, card, GOLDEN)
    _say(f"launches after the single-sequence runs: {cuda_assoc.launches}")
    phase_auto(images, traj, out, dev, card)
    phase_batched(cfg, images, traj, out, dev, card)
    launches = dict(cuda_assoc.launches)
    _say(f"kernel launches in the main-path runs: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was never launched")

    src_rel = os.path.relpath(_build.SOURCE, ROOT)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src_rel,
         "replaces": KERNELS[name], "launches": launches[name],
         **kernels[name]} for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
