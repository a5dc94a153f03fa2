"""Where the time of the port's image ingest goes, on one CUDA card.

    python tools/profile_torch_ingest.py [--frames 16]

Renders `--frames` sweeps of chip_smoke.py's CFEAR-3 slice (Oxford scale,
400 x 3768) and measures, on the card:

- `filtering.filter_polar_image` for one sweep and for the whole chunk,
  k-strongest (the slice), k-strongest with the adaptive noise floor
  (`z_min_quantile` 0.98) and CA-CFAR: device ms and kernel launches per
  call from a torch.profiler trace, the host ms it takes to queue one call
  (five calls queued behind a `torch.cuda._sleep` spin, so the device
  cannot hold the host back; more would fill the card's queue of about a
  thousand pending launches, and the host would wait for the spin), and
  whether a call synchronises with the card
  (`torch.cuda.set_sync_debug_mode`);
- the upload of the chunk: a pageable copy and the runner's
  `odometry.upload_images` (pinned memory from torch's caching host
  allocator), each as host ms until the copy has completed.

Prints one line per measurement and, last, one JSON object with every
number and the card's name and power limit. Needs a card; exits 2 without.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from cfear_radarodometry_code_public_tpu_torch.models import odometry  # noqa: E402
from cfear_radarodometry_code_public_tpu_torch.ops import filtering  # noqa: E402


def profiled_ms(fn, n: int):
    """(device ms, kernel launches) per call of fn() over n calls, summed
    from a torch.profiler trace of the card, whatever the host's pace: for
    a chain of torch ops such as the image filter (about a hundred
    launches a call), where n calls queued behind a spin would fill the
    card's queue of about a thousand pending launches, and the host would
    wait."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    us = sum(e.self_device_time_total for e in kernels)
    return us / 1e3 / n, sum(e.count for e in kernels) / n


def host_queue_ms(fn, n: int = 5) -> float:
    """Host ms to queue one call of fn(), the calls held behind a spin."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def syncs(fn) -> bool:
    """Whether fn() makes a call that synchronises with the card."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError as e:
        if "synchronizing" not in str(e):
            raise
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def upload_ms(fn, n: int = 10) -> float:
    """Host ms of fn() (an upload) until its copy has completed."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_ingest: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = chip_smoke._card()
    cfg = chip_smoke.slice_config()
    images, _ = chip_smoke.synthetic.make_sequence(
        cfg=cfg, **dict(chip_smoke.SEQUENCE, n_frames=args.frames))
    chunk = torch.as_tensor(images).to(dev)
    rec = {"card": card, "frames": args.frames,
           "shape": list(images.shape[1:])}
    cfar = cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                  method="cacfar"))
    floor = cfg.replace(filter=dataclasses.replace(cfg.filter,
                                                   z_min_quantile=0.98))
    for method, c in (("kstrong", cfg), ("kstrong_q98", floor),
                      ("cacfar", cfar)):
        for name, x in (("one", chunk[0]), ("chunk", chunk)):
            def call(x=x, c=c):
                return filtering.filter_polar_image(x, c)
            ms, launches = profiled_ms(call, 10)
            host = host_queue_ms(call)
            sync = syncs(call)
            rec[f"{method}_{name}"] = {"device_ms": ms, "launches": launches,
                                       "host_queue_ms": host, "syncs": sync}
            print(f"filter_polar_image {method}, {name} "
                  f"({x.shape[0] if x.dim() == 3 else 1} frames): {ms:.4f} "
                  f"device ms, {launches:.0f} launches, {host:.3f} host ms "
                  f"to queue, synchronises: {sync} ({card})", flush=True)
    for name, fn in (
            ("pageable", lambda: torch.as_tensor(images).to(
                dev, non_blocking=True)),
            ("pinned", lambda: odometry.upload_images(images, dev))):
        ms = upload_ms(fn)
        rec[f"upload_{name}_ms"] = ms
        print(f"upload of {args.frames} sweeps ({images.nbytes / 1e6:.1f} "
              f"MB), {name}: {ms:.3f} ms ({card})", flush=True)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
