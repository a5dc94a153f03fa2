"""Where the time goes in the PyTorch port's CFEAR-3 slice on a CUDA card.

    python tools/profile_torch_port.py [--frames 24] [--batch 8]
                                       [--feature-backends auto,pallas]

Runs `chip_smoke.py`'s configuration (CFEAR-3, Oxford scale, bench
settings) on synthetic frames, once per feature backend ("auto": the
scatter form; "pallas": kernel G), warms up, then traces a window of frames
with `torch.profiler` for the single-sequence step and the batched step.
Prints per window: wall ms per step (second of two unprofiled passes; the
first beside it), device busy ms per step (sum of kernel
times) and the idle share, kernel launches per step, the time under each
stage range (`Filtering`, `compensate`, `build_normals`, `register`,
`associate`, `lm_solve`) and the top kernels. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from cfear_radarodometry_code_public_tpu_torch._shared import synthetic  # noqa: E402
from cfear_radarodometry_code_public_tpu_torch.models import odometry  # noqa: E402

STAGES = ("Filtering", "compensate", "build_normals", "register", "associate",
          "lm_solve")


def _window(name, step, state, frames, card):
    """Time the steps over `frames` from `state` without the profiler, then
    trace the same steps from the same state and report."""
    def run():
        st = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            st, _ = step(st, f)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    steps = len(frames)
    # two unprofiled passes: the first may carry one-off costs (allocator
    # growth, lazy library init) that a short window would spread per step
    first_ms, plain_ms = (run() * 1e3 / steps for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = run() * 1e3 / steps
    ev = prof.events()
    cuda = [e for e in ev if e.device_type == DeviceType.CUDA]
    kernels = [e for e in cuda if e.name not in STAGES]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    print(f"[{name}] {card}: wall {plain_ms:.3f} ms/step (first pass "
          f"{first_ms:.3f}, {wall_ms:.3f} with the profiler on), device busy "
          f"{busy_ms:.3f} ms/step, idle share {1 - busy_ms / plain_ms:.3f} of "
          f"the unprofiled wall, kernel launches {len(kernels) / steps:.0f}"
          "/step")
    for st in STAGES:
        host = [e for e in ev if e.name == st and e.device_type == DeviceType.CPU]
        span = [e for e in cuda if e.name == st]
        in_st = [k for k in kernels if any(
            s.time_range.start <= k.time_range.start < s.time_range.end
            for s in span)]
        print(f"[{name}]   {st:14s} host "
              f"{sum(e.time_range.elapsed_us() for e in host) / 1e3 / steps:8.3f}"
              f" ms/step, device busy "
              f"{sum(k.time_range.elapsed_us() for k in in_st) / 1e3 / steps:8.3f}"
              f" ms/step, kernels {len(in_st) / steps:7.1f}/step, calls "
              f"{len(host) / steps:.1f}/step")
    by_name: dict = {}
    for k in kernels:
        t, c = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.time_range.elapsed_us(), c + 1)
    for kname, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[{name}]   kernel {t / 1e3 / steps:8.4f} ms/step "
              f"x{c / steps:7.1f}  {kname[:90]}")


def _profile(cfg, tag, args, dev, card):
    n = args.frames
    images, _ = synthetic.make_sequence(cfg=cfg, **chip_smoke.SEQUENCE)
    rows = odometry.host_filter(images[:n], cfg, "compact")
    half = n // 2

    # single sequence: the step as OdometryRunner drives it, inputs staged
    staged = odometry.to_device(rows, dev)
    frames = [odometry._map(lambda a: a[t], staged) for t in range(n)]
    step = odometry.make_step(cfg)
    state = odometry.init_state(cfg, dev)
    state, _ = odometry.make_bootstrap(cfg)(state, frames[0])
    for f in frames[1:half]:
        state, _ = step(state, f)
    _window(f"{tag} single", step, state, frames[half:], card)

    # batched: the same frames in every lane
    b = args.batch
    staged = odometry.to_device(odometry.filtering.CompactCandidates(
        *(np.broadcast_to(a[:, None], (n, b) + a.shape[1:]) for a in rows)),
        dev)
    frames = [odometry._map(lambda a: a[t], staged) for t in range(n)]
    step = odometry.make_batched_step(cfg)
    states = odometry.init_state(cfg, dev, batch=b)
    states, _ = odometry.make_bootstrap(cfg, batched=True)(states, frames[0])
    for f in frames[1:half]:
        states, _ = step(states, f)
    _window(f"{tag} batched_x{b}", step, states, frames[half:], card)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--feature-backends", default="auto,pallas")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    for backend in args.feature_backends.split(","):
        _profile(chip_smoke.slice_config(feature_backend=backend), backend,
                 args, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
