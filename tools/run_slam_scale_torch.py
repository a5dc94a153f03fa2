"""The SLAM pass of the PyTorch/CUDA port at Oxford sensor scale.

The port's counterpart of `tools/run_slam_scale.py`, with its stages,
flags, world and settings: a multi-lap circuit (laps of one closed loop in
the seed-9 world of extent 300 m, `eval/slam_scale.make_lap_sequence`),
CFEAR-3 at Oxford width (400 x 3768) with max_cells 1024, point_budget 8192
and Morton-ordered cells. Stages: host-ingest odometry (`OdometryRunner`),
the graph with scan payloads recomputed on the device, the payload stack,
the descriptor pass, `close_from_graph` (proposal, verification in chunks
of 512 lanes: kernels A and F on a card, acceptance), optional mini loops,
`to_arrays` and `optimize` (40 GN x 400 PCG iterations). Each stage's wall
time is read after a device synchronise; then the loop residuals and the
keyframe ATE before and after closure.

    python tools/run_slam_scale_torch.py [--frames 4096 --lap-frames 1024]
        [--dropout 0.3] [--mini-loops] [--out FILE]
    python tools/run_slam_scale_torch.py --cpu --frames 48 --lap-frames 24

The card by default (raises without one); `--cpu` runs on the CPU with the
synthetic sensor. Writes eval_results/SLAM_SCALE_torch_h100.txt (`--out`),
whose header carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import cfear_radarodometry_code_public_tpu_torch as port  # noqa: E402
from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale  # noqa: E402
from cfear_radarodometry_code_public_tpu_torch.models import (  # noqa: E402
    loopclosure, odometry, posegraph)
from cfear_radarodometry_code_public_tpu_torch.ops import (  # noqa: E402
    cuda_assoc, cuda_lm)


def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4096)
    ap.add_argument("--lap-frames", type=int, default=1024)
    ap.add_argument("--speed", type=float, default=2.5)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--max-cells", type=int, default=1024)
    ap.add_argument("--extent", type=float, default=300.0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="azimuth-wedge dropout probability of the render")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--cg-iters", type=int, default=400)
    ap.add_argument("--mini-loops", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="eval_results/SLAM_SCALE_torch_h100.txt")
    args = ap.parse_args(argv)

    dev = odometry.resolve_device("cpu" if args.cpu else "cuda",
                                  "run_slam_scale_torch")
    cfg = port.preset("CFEAR-3", dataset="synthetic" if args.cpu else "oxford")
    cfg = cfg.replace(feature=dataclasses.replace(
        cfg.feature, max_cells=args.max_cells, point_budget=8192,
        spatial_sort=True))
    where = "CPU" if args.cpu else (
        f"{card_name()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lines = [f"full-scale SLAM pass, PyTorch/CUDA port ({where}): "
             f"{args.frames} frames = {args.frames / args.lap_frames:.1f} laps "
             f"x {args.lap_frames}, speed {args.speed} m/s, extent "
             f"{args.extent}, max_cells={args.max_cells}, verify chunk "
             f"{loopclosure.LoopCloser.VERIFY_CHUNK}"]

    def say(line):
        lines.append(line)
        print(line, flush=True)

    def stage(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        say(f"  {name:34s} {time.perf_counter() - t0:8.2f} s")
        return time.perf_counter()

    t0 = time.perf_counter()
    images, gt = slam_scale.make_lap_sequence(
        cfg, args.frames, args.lap_frames, args.speed, args.extent,
        args.dropout)
    t0 = stage(f"render ({args.frames} frames, dropout={args.dropout})", t0)

    runner = odometry.OdometryRunner(cfg, chunk=args.chunk, ingest="host",
                                     device=dev)
    runner.process(images)
    traj, out = runner.trajectory(), runner.frame_outputs()
    t0 = stage("odometry (incl. warm-up)", t0)
    kf = np.flatnonzero(np.asarray(out.fused))
    say(f"  keyframes: {len(kf)} of {args.frames} frames; failures "
        f"{int((~np.asarray(out.success)).sum())}")

    gb = posegraph.build_graph_from_odometry(out, traj, images=images,
                                             cfg=cfg, device=dev)
    t0 = stage("graph build + payloads", t0)
    closer = loopclosure.LoopCloser(cfg, device=dev)
    stacked = closer.stack(gb)
    t0 = stage("payload stack", t0)
    rk, sh = closer.descriptors(stacked)
    t0 = stage("descriptor pass", t0)
    cuda_assoc.reset_launches()
    cuda_lm.reset_launches()
    accepted = closer.close_from_graph(gb, precomputed=(stacked, rk, sh))
    t0 = stage("proposal+verify+accept", t0)
    launches = {**cuda_assoc.launches, **cuda_lm.launches}
    n_loops = len(accepted)
    n_cand = gb.n_constraints(posegraph.CANDIDATE)
    say(f"  accepted loop edges: {n_loops}; stored candidates: {n_cand}; "
        f"kernel launches in verification: {json.dumps(launches)}")
    if args.mini_loops:
        closer.add_mini_loops(gb)
        t0 = stage("mini loops", t0)
    graph = gb.to_arrays(device=dev)
    t0 = stage("to_arrays", t0)
    opt, _ = posegraph.optimize(graph, iters=args.iters,
                                cg_iters=args.cg_iters)
    opt = opt.poses.cpu().numpy()[:len(kf)]
    t0 = stage(f"optimize ({args.iters} GN x {args.cg_iters} PCG)", t0)

    lr0 = slam_scale.loop_residuals(gb.edges, traj[kf],
                                    posegraph.LOOP_APPEARANCE)
    lr1 = slam_scale.loop_residuals(gb.edges, opt, posegraph.LOOP_APPEARANCE)
    say(f"  loop residuals: init median {np.median(lr0):.3f} m (p90 "
        f"{np.percentile(lr0, 90):.3f}) -> optimized median "
        f"{np.median(lr1):.3f} m (p90 {np.percentile(lr1, 90):.3f})")
    ate_odo = slam_scale.keyframe_ate(traj[kf], gt[kf])
    ate_slam = slam_scale.keyframe_ate(opt, gt[kf])
    say(f"  keyframe ATE: odometry {ate_odo:.3f} m -> closed {ate_slam:.3f} "
        f"m ({n_loops} loop edges over {len(kf)} keyframes)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {args.out}")
    if n_loops and ate_slam > ate_odo:
        print("WARNING: closure did not improve keyframe ATE")
    return dict(n_kf=len(kf), n_loops=n_loops, n_cand=n_cand,
                ate_odo=ate_odo, ate_slam=ate_slam, launches=launches)


if __name__ == "__main__":
    main()
