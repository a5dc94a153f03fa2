"""Write the JAX golden trajectories that `chip_smoke.py` holds the PyTorch
port against.

Runs the JAX reference on the CPU over one of chip_smoke's sequences and
configurations, with `assoc_method="pallas_sparse"`, so the block-sparse
Pallas kernel runs in interpret mode with the arithmetic of the port's
kernel C, and writes poses, keyframe and success flags, association counts,
the ATE against ground truth, and the configuration and sequence as JSON to
`cfear_radarodometry_code_public_tpu_torch/golden/`:

- `--preset CFEAR-3` (the default): `chip_smoke.slice_config()` over
  `chip_smoke.SEQUENCE` (64 frames) -> `cfear3_oxford_seed1_64.npz`; with
  `--feature-backend pallas` the configuration also sets
  `feature.backend="pallas"` (the moment kernel runs in interpret mode) and
  the file is `cfear3_oxford_seed1_64_pallasfeat.npz`.
- `--preset CFEAR-3-s50`: `chip_smoke.s50_config()` (the 50-keyframe
  window) over `chip_smoke.S50_SEQUENCE` (128 frames) ->
  `cfear3s50_oxford_seed1_128.npz`; with `--k-active 16`,
  `chip_smoke.s50_config(16)` -> `cfear3s50k16_oxford_seed1_128.npz`.
- `--preset longrun`: `chip_smoke.longrun_config(--max-cells,
  --health-every)` over the world of `--seed`, `--frames`, `--speed`,
  `--extent` (and the adversarial knobs with `--adversarial`) ->
  `chip_smoke.longrun_golden(sequence)`. The defaults are
  `chip_smoke.LONGRUN_SEQUENCE` (easy world, 12 m/s, 256 frames ->
  `cfear3_longrun_seed11_256_12ms.npz`); `--adversarial --speed 8` is
  `chip_smoke.LONGRUN_ADV8_SEQUENCE` (`cfear3_longrun_adv_seed11_256_8ms.npz`)
  and `--adversarial --speed 12 --frames 384` is
  `chip_smoke.LONGRUN_ADV12_SEQUENCE`, the breaking regime
  (`cfear3_longrun_adv_seed11_384_12ms.npz`): 384 is the smallest multiple
  of 128 frames at which the reference marks a health check unhealthy (at
  256 frames none of 31 checks is; at 384 one of 47, frame 328).
  The configuration keeps the preset's `assoc_method="auto"`, which
  resolves to kernel A on a card; the reference runs it as
  `assoc_method="pallas"` (kernel A in interpret mode), and the file also
  holds the health fields and the KITTI drift.
- `--preset cli`: the reference's offline CLI itself, run as
  `python -m cfear_radarodometry_code_public_tpu.offline_odometry
  <chip_smoke.cli_args(config, out)> --cpu`, with `chip_smoke.cli_config()`
  (the CFEAR-3 Oxford preset) written as the --config-file, over
  `chip_smoke.CLI_SEQUENCE` (32 frames), the default image ingest and
  --save-graph -> `cfear3_cli_oxford_seed1_32.npz`: the poses of
  `est/00.txt`, the keyframe flags and node and edge counts of
  `simple_graph.npz` (`chip_smoke.read_cli_run`) and the CLI's result.
  `auto` is the dense association on the CPU; on a card the port resolves
  it to kernel A.
- `--preset slam`: the reference's SLAM pass as `tools/run_slam_scale.py`
  runs it, with `chip_smoke.slam_config()` over `chip_smoke.SLAM_SEQUENCE`
  (512 frames, 2 laps of the seed-9 world) and `chip_smoke.SLAM_ITERS`:
  host-ingest odometry, the graph with scan payloads, `close_from_graph`,
  `to_arrays`, `optimize` -> `cfear3_slam_seed9_512.npz`: the odometry
  poses and keyframe flags, the graph arrays `to_arrays` wrote (`g_*`), the
  optimized poses, loop and candidate counts, loop residuals and keyframe
  ATE before and after. The association runs as `assoc_method="pallas"`
  (kernel A in interpret mode, what `auto` resolves to on a card).
- `--preset merge`: the reference's multi-session merge. Session A is the
  `slam` preset's pass up to `close_from_graph`; session B drives the same
  world along the route from frame `chip_smoke.MERGE_SEQUENCE["start"]`
  for its `n_frames` with its own speckle
  (`slam_scale.make_route_slice`); then `merge_many([A, B],
  iters=chip_smoke.MERGE_ITERS)` -> `cfear3_merge_seed9_512_128.npz`: the
  verified and inlier (A node, B node) pairs, the candidate count, `t_ab`,
  B's keyframe flags, poses and ground truth, the merged optimized poses,
  and B's keyframe error after the merge and with the identity alignment.
- `--preset sweep`: the reference's evaluation sweep as
  `tools/run_ablation_sweep.py` runs it, cut to `chip_smoke.SWEEP_JOBS`
  (six jobs of its grids, the adaptive threshold and time-continuous
  registration) in its adversarial world at
  `chip_smoke.SWEEP_SEQUENCE` (48 frames): the reference's
  `parallel.sweep.run_sweep` and offline CLI with the CFEAR-3 synthetic
  preset as --config-file and `assoc_method="pallas"` (kernel A in
  interpret mode, what `auto` resolves to on a card) ->
  `cfear3_sweep_adv_seed11_48.npz`: each job's poses, keyframe and success
  flags, drift and ATE.

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --feature-backend pallas
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset CFEAR-3-s50
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset CFEAR-3-s50 --k-active 16
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset longrun
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset longrun --adversarial --speed 8
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset longrun --adversarial --speed 12 --frames 384
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset cli
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset slam
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset merge
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset sweep

On one CPU process the first takes about 10 s and the second about a
minute; the s50 exact golden took 39 s and the K16 golden 18 s (rendering
of the 128 frames excluded); each longrun golden about a minute, the
384-frame one 61 s.

With `--assoc-method dense` the tool runs the same configuration with the
reference's dense association instead, writes nothing, and prints that
run's spread from the committed golden (max per pose, yaw and
frame-to-frame motion, and whether the keyframe decisions agree): the
reference's own spread between its two association backends, on which
`chip_smoke.TOL`, `chip_smoke.S50_TOL` and `chip_smoke.LONGRUN_TOL` are
set at about 3x; for longrun it also prints the spread of the health
fields.

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset CFEAR-3-s50 --assoc-method dense
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tempfile  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from cfear_radarodometry_code_public_tpu.config import CFEARConfig  # noqa: E402
from cfear_radarodometry_code_public_tpu.datasets import synthetic  # noqa: E402
from cfear_radarodometry_code_public_tpu.eval.kitti import kitti_drift  # noqa: E402
from cfear_radarodometry_code_public_tpu.eval.trajectory import ate_rmse  # noqa: E402
from cfear_radarodometry_code_public_tpu.models.odometry import OdometryRunner  # noqa: E402
from cfear_radarodometry_code_public_tpu import offline_odometry  # noqa: E402


def cli_golden() -> None:
    """`--preset cli`: the reference CLI on the CPU -> chip_smoke.GOLDEN_CLI."""
    cfg_dict = chip_smoke.cli_config().to_dict()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cfear3_oxford.json")
        CFEARConfig.from_dict(cfg_dict).save(path)
        out_dir = os.path.join(tmp, "run")
        argv = chip_smoke.cli_args(path, out_dir) + ["--cpu"]
        result = offline_odometry.main(argv)
        run = chip_smoke.read_cli_run(
            out_dir, CFEARConfig.from_dict(cfg_dict).radar.sensor_period)
    np.savez_compressed(
        chip_smoke.GOLDEN_CLI, poses=run["poses"], fused=run["fused"],
        n_nodes=run["n_nodes"], n_edges=run["n_edges"],
        keyframes=result["keyframes"],
        failures=result["registration_failures"],
        ate=np.float64(result["ate_m"]), config=json.dumps(cfg_dict),
        sequence=json.dumps(chip_smoke.CLI_SEQUENCE),
        argv=json.dumps(argv[:argv.index("--output-dir")] + ["--cpu"]))
    print(f"{chip_smoke.GOLDEN_CLI}: {result['frames']} frames, ATE "
          f"{result['ate_m']:.4f} m, keyframes {result['keyframes']}, graph "
          f"{run['n_nodes']} nodes / {run['n_edges']} edges, failures "
          f"{result['registration_failures']}, "
          f"{time.perf_counter() - t0:.1f} s on the CPU")


def cli_path_golden(name: str, method: str, compare: bool = False,
                    eager: bool = False, port_cpu: bool = False) -> None:
    """`--preset cli-oxford` (and the other `chip_smoke.CLI_PATHS`): the
    path's inputs written by `chip_smoke.prepare_cli_path` (the dataset
    directory from the simulator with the port's PNG encoder, which the
    reference's loader reads with PIL; or the preset's Oxford form as the
    --config-file), then the reference's CLI with
    `chip_smoke.cli_path_args` and --cpu, its configuration given
    `assoc_method="pallas"` (kernel A in interpret mode, what `auto`
    resolves to on a card) -> `chip_smoke.cli_golden_path(name)`; with
    `method` "dense", the CLI's own `auto` (the dense association on the
    CPU), and with `compare` the golden's own run again (under
    XLA_FLAGS=--xla_cpu_max_isa=AVX: no FMA contraction), its spread from
    the golden printed and nothing written; with `eager` the run goes op
    by op (`jax.disable_jit()`: no fusion across the filter, compensation
    and feature stages), printed in the same way; with `port_cpu` the
    port's CLI runs instead, on the CPU (`auto`: its dense association),
    printed in the same way."""
    import contextlib
    import hashlib
    build = offline_odometry.build_config
    asked = []

    def build_config(args):
        cfg = build(args)
        asked.append(cfg.to_dict())
        if cfg.registration.assoc_method == "grid":
            # the bucket grid is its own golden; "dense" is the exact
            # association it stands in for
            assoc = "dense" if method == "dense" else "grid"
        elif method == "dense":
            return cfg
        else:
            assoc = "pallas"
        return cfg.replace(registration=dataclasses.replace(
            cfg.registration, assoc_method=assoc))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "in")
        written = chip_smoke.prepare_cli_path(name, root)
        argv = chip_smoke.cli_path_args(name, root, os.path.join(tmp, "run"))
        offline_odometry.build_config = build_config
        try:
            if port_cpu:
                from cfear_radarodometry_code_public_tpu_torch import (
                    offline_odometry as port_cli)
                from cfear_radarodometry_code_public_tpu_torch.models import (
                    odometry as port_odometry)
                run = chip_smoke.run_cli(port_cli,
                                         port_odometry.OdometryRunner,
                                         argv + ["--cpu"])
            else:
                with jax.disable_jit() if eager \
                        else contextlib.nullcontext():
                    run = chip_smoke.run_cli(offline_odometry,
                                             OdometryRunner, argv + ["--cpu"])
        finally:
            offline_odometry.build_config = build
    r = run["result"]
    summary = (f"{r['frames']} frames, {r['keyframes']} keyframes, "
               f"{r['registration_failures']} failed "
               f"{np.flatnonzero(~run['success']).tolist()}, ATE "
               f"{r['ate_m']:.4f} m, drift {r['t_err_percent']:.4f}%, graph "
               f"{run['n_nodes']} nodes / {run['n_edges']} edges, "
               f"{time.perf_counter() - t0:.1f} s on the CPU")
    path = chip_smoke.cli_golden_path(name)
    if method == "dense" or compare or eager or port_cpu:
        with np.load(path) as z:
            g = {k: z[k] for k in z.files}
        dpos, dyaw, dmot = chip_smoke.traj_spread(run["poses"], g["poses"])
        label = ("the port on the CPU" if port_cpu else
                 ("dense" if method == "dense" else "again")
                 + (" op by op" if eager else ""))
        print(f"{label} vs "
              f"{os.path.basename(path)}: max |dpos| {dpos:.6f} m, "
              f"|dyaw| {dyaw:.3e} rad, |dmotion| {dmot:.6f} m; keyframe "
              f"flags equal {bool(np.array_equal(run['fused'], g['fused']))}"
              f" (differ at "
              f"{np.flatnonzero(run['fused'] != g['fused']).tolist()}); "
              f"failed frames equal "
              f"{bool(np.array_equal(run['success'], g['success']))}; graph "
              f"counts equal {(run['n_nodes'], run['n_edges']) == (int(g['n_nodes']), int(g['n_edges']))}; "
              + summary)
        return
    images = b"" if written is None else written.tobytes()
    np.savez_compressed(
        path, poses=run["poses"], fused=run["fused"], success=run["success"],
        n_nodes=run["n_nodes"], n_edges=run["n_edges"],
        keyframes=r["keyframes"], failures=r["registration_failures"],
        ate=np.float64(r["ate_m"]), drift=np.float64(r["t_err_percent"]),
        assoc_method=("grid" if asked[0]["registration"]["assoc_method"]
                      == "grid" else "pallas"), config=json.dumps(asked[0]),
        sequence=json.dumps(chip_smoke.cli_path_sequence(name)),
        argv=json.dumps(chip_smoke.cli_path_args(name, "<in>", "<run>")),
        images_sha256=hashlib.sha256(images).hexdigest())
    print(f"{path}: " + summary)


def slam_golden(method: str, dropout: float = 0.0, compare: bool = False,
                eager: bool = False, port_cpu: bool = False,
                render_seed: int | None = None, frames: int = 0) -> None:
    """`--preset slam`: the reference's SLAM pass on the CPU ->
    chip_smoke.GOLDEN_SLAM (with `dropout` 0.35, over
    `chip_smoke.SLAM_DROPOUT_SEQUENCE` -> chip_smoke.GOLDEN_SLAM_DROPOUT);
    with `method` "dense", the same pass with the dense association, with
    `compare` the golden's own pass again (under
    XLA_FLAGS=--xla_cpu_max_isa=AVX: no FMA contraction), with `eager` op
    by op (`jax.disable_jit()`), with `port_cpu` the port's pass on the CPU
    (`chip_smoke.drive_slam`), each printed beside the golden and not
    written. With `render_seed` the sweeps are another draw of the same
    world and route (`slam_scale.make_route_slice` from frame 0 with that
    seed), and with `frames` the sequence's first `frames` frames: nothing
    is written and no golden compared. Every run prints one
    JSON line (`slam pass: {...}`) with its keyframe count, accepted loop
    edges and keyframe ATE, from which the loop-edge spread is read."""
    import contextlib
    from cfear_radarodometry_code_public_tpu.models import (loopclosure,
                                                            posegraph)
    from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale

    cfg_dict = chip_smoke.slam_config().to_dict()
    cfg = CFEARConfig.from_dict(cfg_dict)
    method = "pallas" if method == "pallas_sparse" else method
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, assoc_method=method))
    if dropout not in (0.0, chip_smoke.SLAM_DROPOUT_SEQUENCE["dropout_prob"]):
        raise SystemExit("--dropout is 0 or chip_smoke.SLAM_DROPOUT_SEQUENCE's")
    sequence, golden = ((chip_smoke.SLAM_DROPOUT_SEQUENCE,
                         chip_smoke.GOLDEN_SLAM_DROPOUT) if dropout else
                        (chip_smoke.SLAM_SEQUENCE, chip_smoke.GOLDEN_SLAM))
    if frames:
        sequence = {**sequence, "n_frames": frames}
    if render_seed is None:
        images, gt = slam_scale.make_lap_sequence(cfg, **sequence)
    else:
        images, gt = slam_scale.make_route_slice(
            cfg, start=0, render_seed=render_seed,
            **{k: v for k, v in sequence.items() if k != "seed"})
    times = {}
    t0 = time.perf_counter()
    if port_cpu:
        import torch
        from cfear_radarodometry_code_public_tpu_torch import config as pconfig
        res = chip_smoke.drive_slam(
            pconfig.CFEARConfig.from_dict(cfg_dict), images,
            torch.device("cpu"))
        traj, out, gb = res["traj"], res["out"], res["gb"]
        accepted, opt, times = res["accepted"], res["opt"], res["secs"]
        kf = np.flatnonzero(np.asarray(out.fused))
    else:
        with jax.disable_jit() if eager else contextlib.nullcontext():
            runner = OdometryRunner(cfg, chunk=32, ingest="host")
            runner.process(images)
            traj, out = np.asarray(runner.trajectory()), runner.frame_outputs()
            kf = np.flatnonzero(np.asarray(out.fused))
            times["odometry"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            gb = posegraph.build_graph_from_odometry(out, traj, images=images,
                                                     cfg=cfg)
            times["graph"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            accepted = loopclosure.LoopCloser(cfg).close_from_graph(gb)
            times["close"] = time.perf_counter() - t0
            graph = gb.to_arrays()
            t0 = time.perf_counter()
            opt, _ = posegraph.optimize(graph, **chip_smoke.SLAM_ITERS)
            opt = np.asarray(opt.poses)
            times["optimize"] = time.perf_counter() - t0
    lr0 = slam_scale.loop_residuals(gb.edges, traj[kf],
                                    posegraph.LOOP_APPEARANCE)
    lr1 = slam_scale.loop_residuals(gb.edges, opt, posegraph.LOOP_APPEARANCE)
    ate_odo = slam_scale.keyframe_ate(traj[kf], gt[kf])
    ate_slam = slam_scale.keyframe_ate(opt, gt[kf])
    label = ("port-cpu" if port_cpu else
             ("dense" if method == "dense" else "kernel-A")
             + ("-eager" if eager else "")
             + ("-avx" if "max_isa=AVX" in os.environ.get("XLA_FLAGS", "")
                else ""))
    print("slam pass: " + json.dumps({
        "variant": label, "render_seed": render_seed, "dropout": dropout,
        "frames": len(traj),
        "keyframes": len(kf), "accepted": sorted(map(list, accepted)),
        "n_accepted": len(accepted),
        "n_candidates": gb.n_constraints(posegraph.CANDIDATE),
        "ate_odo": float(ate_odo), "ate_slam": float(ate_slam),
        "fused": np.flatnonzero(np.asarray(out.fused)).tolist(),
        "seconds": {k: round(v, 1) for k, v in times.items()}}), flush=True)
    if render_seed is not None or frames:
        return
    if method == "dense" or compare or eager or port_cpu:
        with np.load(golden) as z:
            g = dict(z)
        dpos, dyaw, dmot = chip_smoke.traj_spread(traj, g["poses"])
        both = set(map(tuple, g["accepted"])) & set(accepted)
        print(f"{label} vs "
              f"{os.path.basename(golden)}: odometry "
              f"max |dpos| {dpos:.6f} m, |dyaw| {dyaw:.3e} rad, |dmotion| "
              f"{dmot:.6f} m; keyframe flags equal "
              f"{bool(np.array_equal(out.fused, g['fused']))}, keyframes "
              f"{len(kf)} (golden {int(g['fused'].sum())}); accepted loop "
              f"edges {len(accepted)} (golden {len(g['accepted'])}, "
              f"{len(both)} pairs in both); candidates "
              f"{gb.n_constraints(posegraph.CANDIDATE)} (golden "
              f"{int(g['n_candidates'])}); keyframe ATE {ate_odo:.4f} -> "
              f"{ate_slam:.4f} m (golden {float(g['ate_odo']):.4f} -> "
              f"{float(g['ate_slam']):.4f}); seconds on the CPU "
              + json.dumps({k: round(v, 1) for k, v in times.items()}))
        return
    np.savez_compressed(
        golden, poses=traj, gt=gt, fused=out.fused,
        success=out.success, opt_poses=opt,
        **{"g_" + k: np.asarray(v) for k, v in graph._asdict().items()},
        accepted=np.asarray(accepted, np.int64).reshape(-1, 2),
        n_candidates=gb.n_constraints(posegraph.CANDIDATE),
        loop_res_before=np.median(lr0), loop_res_after=np.median(lr1),
        ate_odo=np.float64(ate_odo), ate_slam=np.float64(ate_slam),
        assoc_method=method, config=json.dumps(cfg_dict),
        sequence=json.dumps(sequence),
        iters=json.dumps(chip_smoke.SLAM_ITERS))
    print(f"{golden}: {len(traj)} frames, {len(kf)} "
          f"keyframes, {len(accepted)} accepted loop edges, "
          f"{gb.n_constraints(posegraph.CANDIDATE)} candidates; loop "
          f"residual median {np.median(lr0):.3f} -> {np.median(lr1):.3f} m; "
          f"keyframe ATE {ate_odo:.4f} -> {ate_slam:.4f} m; all successful "
          f"{bool(np.asarray(out.success).all())}; seconds on the CPU "
          + json.dumps({k: round(v, 1) for k, v in times.items()}))


def merge_golden(method: str) -> None:
    """`--preset merge`: session A as the `slam` golden makes it (odometry,
    the graph with payloads, `close_from_graph`), session B over
    `chip_smoke.MERGE_SEQUENCE` (host-ingest odometry, its graph with
    payloads), then `merge_many([A, B], iters=chip_smoke.MERGE_ITERS)`, on
    the CPU -> chip_smoke.GOLDEN_MERGE; with `method` "dense", the same with
    the dense association, printed beside the golden and not written."""
    from cfear_radarodometry_code_public_tpu.models import (
        loopclosure, multisession, posegraph)
    from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale

    cfg_dict = chip_smoke.slam_config().to_dict()
    cfg = CFEARConfig.from_dict(cfg_dict)
    method = "pallas" if method == "pallas_sparse" else method
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, assoc_method=method))
    seq = chip_smoke.SLAM_SEQUENCE
    times, t0 = {}, time.perf_counter()
    graphs = []
    for make in (lambda: slam_scale.make_lap_sequence(cfg, **seq),
                 lambda: slam_scale.make_route_slice(
                     cfg, lap_frames=seq["lap_frames"], speed=seq["speed"],
                     extent=seq["extent"], **chip_smoke.MERGE_SEQUENCE)):
        images, gt_b = make()
        runner = OdometryRunner(cfg, chunk=32, ingest="host")
        runner.process(images)
        traj, out = np.asarray(runner.trajectory()), runner.frame_outputs()
        graphs.append(posegraph.build_graph_from_odometry(
            out, traj, images=images, cfg=cfg))
        del images
    gb_a, gb_b = graphs      # traj, out and gt_b are session B's
    kf_b = np.flatnonzero(np.asarray(out.fused))
    times["odometry + graphs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loopclosure.LoopCloser(cfg).close_from_graph(gb_a)
    times["close A"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with chip_smoke.recorded(multisession, "cross_session_matches") as found, \
            chip_smoke.recorded(loopclosure.LoopCloser, "_verify") as lanes:
        opt, _, merges, _ = multisession.merge_many(
            [gb_a, gb_b], cfg, iters=chip_smoke.MERGE_ITERS)
    times["merge_many"] = time.perf_counter() - t0
    opt = np.asarray(opt)
    ka = len(gb_a.poses)
    verified = np.asarray([(m["i_a"], m["j_b"]) for m in found[0][1]],
                          np.int64).reshape(-1, 2)
    inliers = np.asarray([(m["i_a"], m["j_b"]) for m in merges[0]["inliers"]],
                         np.int64).reshape(-1, 2)
    t_ab = np.asarray(merges[0]["t_ab"])
    err, err_id = chip_smoke.merge_errors(opt[ka:], np.stack(gb_b.poses),
                                          gt_b[kf_b])
    summary = (f"session A {ka} nodes, session B {len(gb_b.poses)} nodes; "
               f"{len(lanes[0][0]["src_idx"])} candidate pairs; {len(verified)} "
               f"verified, {len(inliers)} inliers; t_ab {t_ab.tolist()} "
               f"(B's true start {gt_b[0].tolist()}); B's keyframe error "
               f"{err:.4f} m merged, {err_id:.4f} m with the identity "
               "alignment; seconds on the CPU "
               + json.dumps({k: round(v, 1) for k, v in times.items()}))
    if method == "dense":
        with np.load(chip_smoke.GOLDEN_MERGE) as z:
            g = dict(z)
        got = set(map(tuple, inliers.tolist()))
        want = set(map(tuple, g["inliers"].tolist()))
        print(f"dense vs {os.path.basename(chip_smoke.GOLDEN_MERGE)}: "
              f"inliers {len(got)} (golden {len(want)}, {len(got & want)} "
              f"in both); verified {len(verified)} (golden "
              f"{len(g['verified'])}); |d t_ab| "
              f"{np.abs(t_ab[:2] - g['t_ab'][:2]).max():.6f} m, "
              f"{abs(t_ab[2] - g['t_ab'][2]):.3e} rad; B's merged keyframe "
              f"error {err:.4f} m (golden {float(g['err_merged']):.4f}); "
              f"merged poses max |dxy| "
              f"{np.abs(opt[:, :2] - g['opt_poses'][:, :2]).max():.6f} m; "
              + summary)
        return
    np.savez_compressed(
        chip_smoke.GOLDEN_MERGE, opt_poses=opt, verified=verified,
        inliers=inliers, t_ab=t_ab, n_candidates=len(lanes[0][0][3]),
        a_nodes=ka, b_fused=np.asarray(out.fused), b_poses=traj,
        b_gt=gt_b, err_merged=np.float64(err),
        err_identity=np.float64(err_id), assoc_method=method,
        config=json.dumps(cfg_dict), sequence=json.dumps(seq),
        merge_sequence=json.dumps(chip_smoke.MERGE_SEQUENCE),
        iters=json.dumps(chip_smoke.MERGE_ITERS))
    print(f"{chip_smoke.GOLDEN_MERGE}: " + summary)


def merge3_golden(method: str) -> None:
    """`--preset merge3`: the reference's merge CLI over three session
    graphs on the CPU -> chip_smoke.GOLDEN_MERGE3. Session A as the `slam`
    golden makes it (odometry, the graph with payloads,
    `close_from_graph`), B over `chip_smoke.MERGE_SEQUENCE` and C over
    `chip_smoke.MERGE3_SEQUENCE` (host-ingest odometry, the graph with
    payloads), each saved by the reference's `GraphBuilder.save`; then
    `merge_sessions.main(chip_smoke.merge3_args(...) + ["--cpu"])` with its
    preset given `assoc_method="pallas"` (kernel A in interpret mode, what
    `auto` resolves to on a card), the merged graph and TUM file read back.
    With `method` "dense", the same with the dense association throughout,
    printed beside the golden and not written."""
    from cfear_radarodometry_code_public_tpu import config as jconfig
    from cfear_radarodometry_code_public_tpu import merge_sessions
    from cfear_radarodometry_code_public_tpu.models import (
        loopclosure, multisession, posegraph)
    from cfear_radarodometry_code_public_tpu_torch.eval import slam_scale

    cfg_dict = chip_smoke.slam_config().to_dict()
    method = "pallas" if method == "pallas_sparse" else method
    cfg = CFEARConfig.from_dict(cfg_dict)
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, assoc_method=method))
    seq = chip_smoke.SLAM_SEQUENCE
    times, t0 = {}, time.perf_counter()
    sessions = []
    for make in (lambda: slam_scale.make_lap_sequence(cfg, **seq),
                 *(lambda s=s: slam_scale.make_route_slice(
                     cfg, lap_frames=seq["lap_frames"], speed=seq["speed"],
                     extent=seq["extent"], **s)
                   for s in (chip_smoke.MERGE_SEQUENCE,
                             chip_smoke.MERGE3_SEQUENCE))):
        images, gt = make()
        runner = OdometryRunner(cfg, chunk=32, ingest="host")
        runner.process(images)
        traj, out = np.asarray(runner.trajectory()), runner.frame_outputs()
        gb = posegraph.build_graph_from_odometry(out, traj, images=images,
                                                 cfg=cfg)
        sessions.append({"gb": gb, "traj": traj, "gt": gt,
                         "fused": np.asarray(out.fused)})
        del images
    times["odometry + graphs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loopclosure.LoopCloser(cfg).close_from_graph(sessions[0]["gb"])
    times["close A"] = time.perf_counter() - t0
    preset = jconfig.preset
    built = []

    def preset_a(*args, **kw):
        c = preset(*args, **kw)
        built.append(c)
        return c.replace(registration=dataclasses.replace(
            c.registration, assoc_method=method))

    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name, sess in zip("abc", sessions):
            paths.append(os.path.join(tmp, f"{name}.npz"))
            sess["gb"].save(paths[-1])
        out_path, tum = os.path.join(tmp, "merged.npz"), os.path.join(
            tmp, "merged.tum")
        argv = chip_smoke.merge3_args(paths, out_path, tum) + ["--cpu"]
        jconfig.preset = preset_a
        t0 = time.perf_counter()
        try:
            with chip_smoke.recorded(multisession, "cross_session_matches") \
                    as found, chip_smoke.recorded(
                        multisession, "align_from_matches") as aligned, \
                    chip_smoke.recorded(loopclosure.LoopCloser,
                                        "_verify") as lanes:
                result = merge_sessions.main(argv)
        finally:
            jconfig.preset = preset
        times["merge CLI"] = time.perf_counter() - t0
        merged = posegraph.GraphBuilder.load(out_path)
        tum_rows = chip_smoke.read_tum(tum)
    # the CLI's preset (before its --max-cells, the sessions' budget)
    cli_reg = dataclasses.asdict(built[0].registration)
    if {k: v for k, v in cli_reg.items() if k != "assoc_method"} != {
            k: v for k, v in cfg_dict["registration"].items()
            if k != "assoc_method"}:
        raise SystemExit("merge3: the merge CLI's preset is not the "
                         "sessions' registration")
    opt = np.stack(merged.poses)
    offsets = np.asarray(result["offsets"])
    arrays, lines = {}, []
    for k in (1, 2):
        verified = np.asarray([(m["i_a"], m["j_b"]) for m in found[k - 1][1]],
                              np.int64).reshape(-1, 2)
        t_ab, inl = aligned[k - 1][1]
        inliers = np.asarray([(m["i_a"], m["j_b"]) for m in inl],
                             np.int64).reshape(-1, 2)
        lo, hi = offsets[k], offsets[k] + len(sessions[k]["gb"].poses)
        sess = sessions[k]
        kf = np.flatnonzero(sess["fused"])
        err, err_id = chip_smoke.merge_errors(opt[lo:hi],
                                              np.stack(sess["gb"].poses),
                                              sess["gt"][kf])
        arrays.update({f"verified_{k}": verified, f"inliers_{k}": inliers,
                       f"t_ab_{k}": np.asarray(t_ab),
                       f"pairs_{k}": len(lanes[k - 1][0]["src_idx"]),
                       f"err_{k}": np.float64(err),
                       f"err_identity_{k}": np.float64(err_id),
                       f"fused_{k}": sess["fused"], f"poses_{k}": sess["traj"],
                       f"gt_{k}": sess["gt"]})
        lines.append(f"merge {k}: {len(lanes[k - 1][0]['src_idx'])} candidate "
                     f"pairs, {len(verified)} verified, {len(inliers)} "
                     f"inliers; session {k} keyframe error {err:.4f} m "
                     f"merged, {err_id:.4f} m with the identity alignment")
    t_ab = np.asarray(result["t_ab"])
    if not np.allclose(t_ab, arrays["t_ab_2"]):
        raise SystemExit("merge3: the CLI's last t_ab is not the second "
                         "merge's")
    summary = (f"nodes {[len(x['gb'].poses) for x in sessions]} -> "
               f"{len(merged.poses)}, {len(merged.edges)} edges; "
               + "; ".join(lines) + f"; last t_ab {t_ab.tolist()}; seconds "
               "on the CPU " + json.dumps({k: round(v, 1)
                                           for k, v in times.items()}))
    if method == "dense":
        with np.load(chip_smoke.GOLDEN_MERGE3) as z:
            g = dict(z)
        for k in (1, 2):
            got = set(map(tuple, arrays[f"inliers_{k}"].tolist()))
            want = set(map(tuple, g[f"inliers_{k}"].tolist()))
            print(f"dense vs golden, merge {k}: inliers {len(got)} (golden "
                  f"{len(want)}, {len(got & want)} in both); verified "
                  f"{len(arrays[f'verified_{k}'])} (golden "
                  f"{len(g[f'verified_{k}'])}); pairs {arrays[f'pairs_{k}']} "
                  f"(golden {int(g[f'pairs_{k}'])}); keyframe flags equal "
                  f"{bool(np.array_equal(arrays[f'fused_{k}'], g[f'fused_{k}']))}"
                  f"; session error {float(arrays[f'err_{k}']):.4f} m "
                  f"(golden {float(g[f'err_{k}']):.4f})")
        d = tum_rows[:, 1:3] - g["tum"][:, 1:3]
        print(f"dense vs golden: merged nodes {len(merged.poses)} (golden "
              f"{int(g['n_nodes'])}); |d t_ab| per merge " + ", ".join(
                  f"{np.abs(a[:2] - b[:2]).max():.6f} m / "
                  f"{abs(a[2] - b[2]):.3e} rad" for a, b in (
                      (arrays[f"t_ab_{k}"], g[f"t_ab_{k}"]) for k in (1, 2)))
              + f"; merged poses max |dxy| {np.abs(d).max():.6f} m; "
              + summary)
        return
    np.savez_compressed(
        chip_smoke.GOLDEN_MERGE3, opt_poses=opt, tum=tum_rows,
        n_nodes=len(merged.poses), n_edges=len(merged.edges),
        offsets=offsets, nodes=np.asarray([len(x["gb"].poses)
                                           for x in sessions]),
        assoc_method=method, config=json.dumps(cfg_dict),
        sequence=json.dumps(seq),
        merge_sequences=json.dumps([chip_smoke.MERGE_SEQUENCE,
                                    chip_smoke.MERGE3_SEQUENCE]),
        argv=json.dumps(chip_smoke.merge3_args(["<a>", "<b>", "<c>"],
                                               "<out>", "<tum>")),
        iters=json.dumps(chip_smoke.MERGE_ITERS), **arrays)
    print(f"{chip_smoke.GOLDEN_MERGE3}: " + summary)


def sweep_golden(method: str, compare: bool) -> None:
    """`--preset sweep`: the reference's `parallel.sweep.run_sweep` and
    offline CLI over `chip_smoke.SWEEP_JOBS` on the CPU
    (`chip_smoke.run_sweep_jobs`), the CFEAR-3 synthetic preset given as
    --config-file with kernel A in interpret mode, what `auto` resolves to
    on a card -> chip_smoke.GOLDEN_SWEEP; with `method` "dense", the same
    jobs with the dense association, and with `compare` the same jobs as
    the golden's: each job's spread from the golden printed and nothing
    written (run under XLA_FLAGS=--xla_cpu_max_isa=AVX, the spread of the
    reference's own arithmetic: no FMA contraction)."""
    from cfear_radarodometry_code_public_tpu.config import preset
    from cfear_radarodometry_code_public_tpu.parallel import sweep

    method = "pallas" if method == "pallas_sparse" else method
    cfg = preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, assoc_method=method))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cfear3_synthetic.json")
        cfg.save(path)
        argv = ["--config-file", path] + chip_smoke.sweep_args() + ["--cpu"]
        jobs = chip_smoke.run_sweep_jobs(sweep, OdometryRunner, tmp, argv)
    names = list(jobs)
    secs = time.perf_counter() - t0
    if method == "dense" or compare or eager:
        with np.load(chip_smoke.GOLDEN_SWEEP) as z:
            g = {k: z[k] for k in z.files}
        worst = np.zeros(3)
        for i, name in enumerate(json.loads(str(g["names"]))):
            got = jobs[name]
            spread = chip_smoke.traj_spread(got["poses"], g[f"poses_{i}"])
            worst = np.maximum(worst, spread)
            print(f"{method} vs golden {name}: max |dpos| {spread[0]:.6f} m, "
                  f"|dyaw| {spread[1]:.3e} rad, |dmotion| {spread[2]:.6f} m; "
                  f"keyframe flags equal "
                  f"{bool(np.array_equal(got['fused'], g[f'fused_{i}']))}; "
                  f"failed frames {int((~got['success']).sum())} (golden "
                  f"{int((~g[f'success_{i}']).sum())}); drift "
                  f"{float(got['result']['t_err_percent']):.4f}% (golden "
                  f"{float(g['drift'][i]):.4f}%), ATE "
                  f"{float(got['result']['ate_m']):.4f} m (golden "
                  f"{float(g['ate'][i]):.4f})")
        print(f"{method} vs golden, the worst job: max |dpos| {worst[0]:.6f} m, "
              f"|dyaw| {worst[1]:.3e} rad, |dmotion| {worst[2]:.6f} m; "
              f"{secs:.1f} s on the CPU")
        return
    arrays = {}
    for i, name in enumerate(names):
        arrays.update({f"poses_{i}": jobs[name]["poses"],
                       f"fused_{i}": jobs[name]["fused"],
                       f"success_{i}": jobs[name]["success"]})
    os.makedirs(os.path.dirname(chip_smoke.GOLDEN_SWEEP), exist_ok=True)
    np.savez_compressed(
        chip_smoke.GOLDEN_SWEEP, names=json.dumps(names),
        jobs=json.dumps(chip_smoke.SWEEP_JOBS),
        sequence=json.dumps(chip_smoke.SWEEP_SEQUENCE),
        argv=json.dumps(chip_smoke.sweep_args()), assoc_method=method,
        drift=np.array([float(jobs[n]["result"]["t_err_percent"])
                        for n in names]),
        ate=np.array([float(jobs[n]["result"]["ate_m"]) for n in names]),
        **arrays)
    for name in names:
        r = jobs[name]["result"]
        print(f"{name}: keyframes {r['keyframes']}, failures "
              f"{r['registration_failures']}, drift {r['t_err_percent']}%, "
              f"ATE {r['ate_m']} m")
    print(f"{chip_smoke.GOLDEN_SWEEP}: {len(names)} jobs, {secs:.1f} s on "
          f"the CPU (assoc {method})")


def target(preset: str, feature_backend: str, k_active: int, args):
    """(configuration, sequence, output path) of one golden."""
    if preset == "longrun":
        sequence = {"seed": args.seed, "n_frames": args.frames,
                    "speed": args.speed, "extent": args.extent}
        if args.adversarial:
            sequence.update(chip_smoke.ADVERSARIAL)
        return (chip_smoke.longrun_config(args.max_cells, args.health_every),
                sequence, chip_smoke.longrun_golden(sequence))
    if preset == "CFEAR-3-s50":
        if feature_backend != "auto":
            raise SystemExit("--feature-backend applies to CFEAR-3 only")
        if k_active not in (0, 16):
            raise SystemExit("--k-active is 0 (exact) or 16")
        path = chip_smoke.GOLDEN_S50_K16 if k_active else chip_smoke.GOLDEN_S50
        return chip_smoke.s50_config(k_active), chip_smoke.S50_SEQUENCE, path
    if k_active:
        raise SystemExit("--k-active applies to CFEAR-3-s50 only")
    if feature_backend == "pallas":
        return (chip_smoke.slice_config(feature_backend="pallas"),
                chip_smoke.SEQUENCE, chip_smoke.GOLDEN_PALLAS)
    return chip_smoke.slice_config(), chip_smoke.SEQUENCE, chip_smoke.GOLDEN


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("CFEAR-3", "CFEAR-3-s50", "longrun",
                                         "cli", "slam", "merge", "merge3",
                                         "sweep",
                                         *chip_smoke.CLI_PATHS),
                    default="CFEAR-3")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="slam: azimuth-wedge dropout of the render (0 or "
                         "0.35, `chip_smoke.SLAM_DROPOUT_SEQUENCE`)")
    ap.add_argument("--render-seed", type=int, default=None,
                    help="slam: render the sweeps from this seed (the same "
                         "world and route); print the pass, write nothing")
    ap.add_argument("--slam-frames", type=int, default=0,
                    help="slam: the sequence's first frames only; print the "
                         "pass, write nothing")
    ap.add_argument("--feature-backend", choices=("auto", "pallas"),
                    default="auto")
    ap.add_argument("--k-active", type=int, default=0)
    ap.add_argument("--assoc-method", choices=("pallas_sparse", "dense"),
                    default="pallas_sparse",
                    help="pallas_sparse: write the golden (longrun: with "
                         "kernel A); dense: print the dense form's spread")
    long = chip_smoke.LONGRUN_SEQUENCE
    ap.add_argument("--max-cells", type=int, default=2048)
    ap.add_argument("--health-every", type=int, default=8)
    ap.add_argument("--seed", type=int, default=long["seed"])
    ap.add_argument("--frames", type=int, default=long["n_frames"])
    ap.add_argument("--speed", type=float, default=long["speed"])
    ap.add_argument("--extent", type=float, default=long["extent"])
    ap.add_argument("--adversarial", action="store_true")
    ap.add_argument("--port-cpu", action="store_true",
                    help="cli-*: the port's CLI on the CPU, its spread from "
                         "the golden printed, nothing written")
    ap.add_argument("--eager", action="store_true",
                    help="cli-*: run op by op (jax.disable_jit()), print the "
                         "spread from the golden and write nothing")
    ap.add_argument("--compare-only", action="store_true",
                    help="sweep, cli-*, slam: print the run's spread from "
                         "the golden and write nothing")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.preset == "cli":
        cli_golden()
        return
    if args.preset == "slam":
        slam_golden(args.assoc_method, args.dropout, args.compare_only,
                    args.eager, args.port_cpu, args.render_seed,
                    args.slam_frames)
        return
    if args.preset in chip_smoke.CLI_PATHS:
        cli_path_golden(args.preset, args.assoc_method, args.compare_only,
                        args.eager, args.port_cpu)
        return
    if args.preset == "merge":
        merge_golden(args.assoc_method)
        return
    if args.preset == "merge3":
        merge3_golden(args.assoc_method)
        return
    if args.preset == "sweep":
        sweep_golden(args.assoc_method, args.compare_only)
        return
    port_cfg, sequence, path = target(args.preset, args.feature_backend,
                                      args.k_active, args)
    cfg_dict = port_cfg.to_dict()
    method = args.assoc_method
    if args.preset == "longrun" and method == "pallas_sparse":
        method = "pallas"          # kernel A, what `auto` resolves to
    cfg = CFEARConfig.from_dict(cfg_dict)
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, assoc_method=method))
    images, gt = synthetic.make_sequence(cfg=cfg, **sequence)
    t0 = time.perf_counter()
    # one chunk size that divides the frames after the bootstrap frame, so
    # the reference compiles no ragged-tail step
    rest = images.shape[0] - 1
    runner = OdometryRunner(cfg, chunk=rest // 3 if rest % 3 == 0 else rest,
                            ingest="host")
    runner.process(images)
    traj = runner.trajectory()
    out = runner.frame_outputs()
    ate = ate_rmse(traj[:, :2], gt[:, :2])
    drift = kitti_drift(traj, gt)
    checked = np.asarray(out.health_checked)
    health = (f"health: {int(checked.sum())} checks, unhealthy "
              f"{float((~out.healthy[checked]).mean()) if checked.any() else 0:.3f}, "
              f"median discrepancy "
              f"{float(np.median(out.health_dist[checked])) if checked.any() else 0:.4f} m")
    if args.assoc_method == "dense":
        with np.load(path) as z:
            g = dict(z)
        dpos, dyaw, dmot = chip_smoke.traj_spread(traj, g["poses"])
        print(f"dense vs {os.path.basename(path)}: max |dpos| {dpos:.6f} m, "
              f"|dyaw| {dyaw:.3e} rad, |dmotion| {dmot:.6f} m; keyframe "
              f"flags equal {bool(np.array_equal(out.fused, g['fused']))}; "
              f"ATE {ate:.4f} m, all successful {bool(out.success.all())}, "
              f"{time.perf_counter() - t0:.1f} s on the CPU")
        if "health_checked" in g:
            hc = g["health_checked"]
            print(f"dense vs golden health: checked flags equal "
                  f"{bool(np.array_equal(checked, hc))}, healthy differs on "
                  f"frames {np.flatnonzero(out.healthy != g['healthy']).tolist()}, "
                  f"max |d health_dist| "
                  f"{float(np.abs(out.health_dist - g['health_dist']).max()):.6f} m, "
                  f"max |d health_rot| "
                  f"{float(np.abs(out.health_rot - g['health_rot']).max()):.3e} rad; "
                  f"KITTI drift {drift['t_err_percent']:.4f}% (golden "
                  f"{float(g['drift']):.4f}%); {health}")
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, poses=traj, gt=gt, fused=out.fused,
        success=out.success, num_assoc=out.num_assoc,
        num_cells=out.num_cells, ate=np.float64(ate),
        health_checked=out.health_checked, healthy=out.healthy,
        health_dist=out.health_dist, health_rot=out.health_rot,
        drift=np.float64(drift["t_err_percent"]), assoc_method=method,
        config=json.dumps(cfg_dict), sequence=json.dumps(sequence))
    print(f"{path}: {images.shape[0]} frames, ATE {ate:.4f} m, KITTI drift "
          f"{drift['t_err_percent']:.4f}%, keyframes {int(out.fused.sum())}, "
          f"all successful {bool(out.success.all())}, {health}, "
          f"{time.perf_counter() - t0:.1f} s on the CPU (assoc {method})")


if __name__ == "__main__":
    main()
