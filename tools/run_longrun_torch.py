"""Long-run drift of the PyTorch/CUDA port at full depth, with a split
resume, in the three worlds of `tools/run_longrun.py`.

The port's counterpart of `tools/run_longrun.py` (which stays the
reference's tool): the same configuration (CFEAR-3 at Oxford scale, host
ingest with point_budget 8192, max_cells 2048, Morton-ordered cells,
`assoc_method="auto"` -> kernel A on the card, the reverse-registration
health check every 8th frame) over the same worlds:

  easy            : the extent-1000 world at 12 m/s
  adversarial     : 40 moving objects, azimuth dropout p=0.5, interference
                    bursts p=0.4, at 12 m/s (the breaking regime)
  adversarial_8ms : the same world at 8 m/s

Each world runs once through `OdometryRunner` (after a short warm-up run)
and once split at the midpoint through `save_checkpoint`/`resume`; the
split run must be bit-identical to the unsplit one (trajectory and every
frame output). Scores use the KITTI evaluator (`eval/kitti.py`, 100-800 m
subsequences). Each world's line is set beside its line of the reference's
artifact `eval_results/LONGRUN_1024_tpu.txt` as accuracy only (drift and
the unhealthy share): that file's frames/s were measured on a TPU and are
no figure of the port's.

Usage (the card by default, about 10 minutes on an H100 for the three
worlds with their renders; --cpu for a short run on the CPU):
  python tools/run_longrun_torch.py [--frames 1024] [--out ...]
  python tools/run_longrun_torch.py --cpu --frames 24 --chunk 8 \\
      --worlds easy --out /tmp/lr.txt
"""

import argparse
import dataclasses
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "eval_results", "LONGRUN_1024_tpu.txt")


def reference_accuracy(path: str = REFERENCE) -> dict:
    """world name -> (t_err %, unhealthy share %) from the reference's
    artifact (lines 2-5)."""
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            m = re.match(r"(\w+) \(\d+ m/s\):.*KITTI t_err ([\d.]+)%.*"
                         r"unhealthy ([\d.]+)%", line)
            if m:
                out[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    return out


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--speed", type=float, default=12.0)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--extent", type=float, default=1000.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--max-cells", type=int, default=2048)
    ap.add_argument("--health-every", type=int, default=8)
    ap.add_argument("--worlds", default="easy,adversarial,adversarial_8ms")
    ap.add_argument("--out", default="eval_results/LONGRUN_1024_torch_h100.txt")
    args = ap.parse_args(argv)

    import torch

    import cfear_radarodometry_code_public_tpu_torch as port
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    from cfear_radarodometry_code_public_tpu_torch.eval.kitti import (
        kitti_drift)
    from cfear_radarodometry_code_public_tpu_torch.models import odometry

    device = "cpu" if args.cpu else "cuda"
    cfg = port.preset("CFEAR-3", dataset="oxford")
    cfg = cfg.replace(
        feature=dataclasses.replace(
            cfg.feature, max_cells=args.max_cells, point_budget=8192,
            spatial_sort=True),
        odometry=dataclasses.replace(
            cfg.odometry, health_check_every=args.health_every))
    where = card() if device == "cuda" else "CPU"
    lines = [f"long-run drift of the PyTorch/CUDA port ({where}; torch "
             f"{torch.__version__}; ingest=host-compact, point_budget=8192, "
             f"max_cells={args.max_cells}, spatial_sort, assoc auto -> "
             f"kernel A on a card, health_check_every={args.health_every}; "
             f"tools/run_longrun_torch.py)"]
    print(lines[0], flush=True)
    ref = reference_accuracy()
    adversarial = dict(n_dynamic=40, dropout_prob=0.5, speckle_burst_prob=0.4)
    worlds = {"easy": (args.speed, {}),
              "adversarial": (args.speed, adversarial),
              "adversarial_8ms": (8.0, adversarial)}

    def run(images, runner=None):
        runner = runner or odometry.OdometryRunner(
            cfg, ingest="host", device=device, chunk=args.chunk)
        runner.process(images)
        if device == "cuda":
            torch.cuda.synchronize()
        return runner

    for name in args.worlds.split(","):
        speed, adv = worlds[name]
        t0 = time.time()
        images, gt = synthetic.make_sequence(
            seed=11, n_frames=args.frames, cfg=cfg, speed=speed,
            extent=args.extent, **adv)
        render_s = time.time() - t0
        path = float(np.sum(np.linalg.norm(np.diff(gt[:, :2], axis=0),
                                           axis=1)))
        run(images[:16])                 # warm-up: build, allocator, threads
        t0 = time.time()
        runner = run(images)
        traj = runner.trajectory()
        wall = time.time() - t0
        out = runner.frame_outputs()
        drift = kitti_drift(traj, gt)
        fails = int((~out.success).sum())
        checked = out.health_checked
        n_checked = int(checked.sum())
        unhealthy = float((~out.healthy[checked]).mean()) if n_checked \
            else float("nan")
        med_hdist = float(np.median(out.health_dist[checked])) \
            if n_checked else float("nan")
        per_len = " ".join(
            f"{k:g}m:{v['t_err_percent']:.3f}%"
            for k, v in sorted(drift.get("per_length", {}).items()))
        ref_txt = (f"; reference artifact (LONGRUN_1024_tpu.txt, accuracy "
                   f"only): t_err {ref[name][0]:.3f}%, unhealthy "
                   f"{ref[name][1]:.1f}%" if name in ref else "")
        lines.append(
            f"{name} ({speed:.0f} m/s): {args.frames} frames, path "
            f"{path:.0f} m, render {render_s:.0f}s, one pass {wall:.1f}s -> "
            f"{args.frames / wall:.1f} fps ({where}, host filter included); "
            f"KITTI t_err {drift['t_err_percent']:.3f}% r_err "
            f"{drift['r_err_deg_per_m']:.5f} deg/m "
            f"({drift['n_subsequences']} subseqs: {per_len}); failures "
            f"{fails}; keyframes {int(out.fused.sum())}; mean cells "
            f"{out.num_cells.mean():.0f}; health: {n_checked} checks, "
            f"unhealthy {unhealthy:.1%} (frames "
            f"{np.flatnonzero(checked & ~out.healthy).tolist()}), median "
            f"rev-discrepancy {med_hdist:.3f} m" + ref_txt)
        print(lines[-1], flush=True)

        # mid-run checkpoint/resume: bit-identical to the unsplit run
        half = (args.frames // 2 // args.chunk) * args.chunk
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "longrun_ckpt.npz")
            run(images[:half]).save_checkpoint(ck)
            r2 = run(images[half:], odometry.OdometryRunner.resume(
                cfg, ck, device=device, chunk=args.chunk, ingest="host"))
        traj2, out2 = r2.trajectory(), r2.frame_outputs()
        identical = bool(np.array_equal(traj2, traj)) and all(
            np.array_equal(a, b) for a, b in zip(out2, out))
        max_dev = float(np.abs(traj2 - traj).max())
        lines.append(f"  {name}: checkpoint/resume split@{half}: "
                     f"bit-identical={identical} (max |delta| {max_dev:.2e})")
        print(lines[-1], flush=True)
        if not identical:
            raise SystemExit(f"{name}: the resumed run differs from the "
                             f"unsplit one by {max_dev}")
        del images

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
