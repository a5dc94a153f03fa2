"""Offline odometry CLI (port of `offline_odometry.py`).

Rebuild of `src/offline_odometry.cpp`: read a sequence (synthetic, Oxford, or
MulRan directory), run the full odometry pipeline on the CUDA card, export
est/gt trajectories (KITTI + TUM + covariance), the pose graph
(`simple_graph.npz`, the `.sgh` equivalent, which the reference's
`GraphBuilder.load` reads), a `pars.txt` parameter+timing manifest
(`offline_odometry.cpp:290-302`), and an in-repo KITTI drift / ATE
`est/result.txt`. The flags are the reference CLI's; `--cpu` runs on the
CPU instead of the card (without it and without a card the CLI raises),
`--trace DIR` writes a `torch.profiler` trace, and `--profile-stages`
times each stage of the real pipeline on the first 8 frames
(`_profile_stages`) into `pars.txt`'s timing table.

Usage:
  python -m cfear_radarodometry_code_public_tpu_torch.offline_odometry \
      --dataset synthetic --n-frames 100 --output-dir /tmp/run
  python -m cfear_radarodometry_code_public_tpu_torch.offline_odometry \
      --dataset oxford --radar-dir .../radar --gt-csv .../radar_odometry.csv \
      --output-dir /tmp/run --preset CFEAR-3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def build_config(args):
    from cfear_radarodometry_code_public_tpu_torch.config import CFEARConfig, preset
    if getattr(args, "config_file", None):
        cfg = CFEARConfig.load(args.config_file)   # YAML/JSON base config
    else:
        cfg = preset(args.preset, dataset=args.dataset)
    filt = dataclasses.replace(
        cfg.filter,
        **{k: v for k, v in dict(
            k_strongest=args.k_strongest, z_min=args.z_min,
            z_min_quantile=args.z_min_quantile,
            method=args.filter_type, cfar_window=args.cfar_window,
            cfar_guard=args.cfar_guard,
            false_alarm_rate=args.false_alarm_rate,
            cfar_max_per_azimuth=args.cfar_max_per_azimuth).items()
           if v is not None})
    feat = dataclasses.replace(
        cfg.feature,
        **{k: v for k, v in dict(
            res=args.res, weight_intensity=args.weight_intensity,
            max_cells=args.max_cells,
            point_budget=args.point_budget,
            spatial_sort=args.spatial_sort or None,
            use_raw_pointcloud=args.use_raw_pointcloud or None).items()
           if v is not None})
    reg = dataclasses.replace(
        cfg.registration,
        **{k: v for k, v in dict(
            cost=args.cost_type, loss=args.loss_type,
            loss_limit=args.loss_limit, weight_opt=args.weight_option,
            cov_scale=args.covar_scale,
            regularization=args.regularization,
            assoc_radius=args.assoc_radius,
            max_itr_association=args.max_itr_association,
            max_active_keyframes=args.max_active_keyframes,
            score_tolerance=args.score_tolerance,
            min_assoc_fraction=args.min_assoc_fraction,
            max_score=args.max_score,
            disable_registration=args.disable_registration or None,
            soft_constraint=args.soft_constraint or None,
            time_continuous=args.time_continuous or None).items()
           if v is not None})
    odo = dataclasses.replace(
        cfg.odometry,
        **{k: v for k, v in dict(
            submap_scan_size=args.submap_scan_size,
            keyframe_min_dist=args.min_keyframe_dist,
            keyframe_min_rot_deg=args.min_keyframe_rot_deg,
            compensate=args.compensate, use_guess=args.use_guess,
            estimate_cov_by_sampling=args.estimate_cov_by_sampling or None,
            ).items() if v is not None})
    return cfg.replace(filter=filt, feature=feat, registration=reg,
                       odometry=odo)


def load_sequence(args, cfg):
    """Returns (images (T, A, R) uint8, stamps (T,), gt (T,3) or None)."""
    from cfear_radarodometry_code_public_tpu_torch.datasets import oxford, synthetic
    if args.dataset == "synthetic":
        images, gt = synthetic.make_sequence(
            args.seed, args.n_frames, cfg, speed=args.speed,
            n_dynamic=args.n_dynamic, dropout_prob=args.dropout_prob,
            speckle_burst_prob=args.speckle_burst_prob)
        stamps = np.arange(len(images)) * cfg.radar.sensor_period
        return images, stamps, gt
    frames = (oxford.oxford_frames(args.radar_dir) if args.dataset == "oxford"
              else oxford.mulran_frames(args.radar_dir))
    stamps, images = [], []
    for i, (t, img) in enumerate(frames):
        if args.n_frames and i >= args.n_frames:
            break
        stamps.append(t)
        a, r = cfg.radar.n_azimuths, cfg.radar.n_bins
        if img.shape != (a, r):
            out = np.zeros((a, r), np.uint8)
            out[:min(a, img.shape[0]), :min(r, img.shape[1])] = \
                img[:a, :r]
            img = out
        images.append(img)
    stamps = np.asarray(stamps)
    gt = None
    if args.gt_csv:
        gt_stamps, gt_poses = oxford.load_gt_csv(args.gt_csv)
        from cfear_radarodometry_code_public_tpu_torch.eval.trajectory import (
            interpolate_gt)
        keep, gt = interpolate_gt(stamps, gt_stamps, gt_poses)
        images = [images[i] for i in keep]
        stamps = stamps[keep]
    return np.stack(images), stamps, gt


def write_pars(path, cfg, args, timing, extra):
    """`pars.txt` manifest: full config + timing statistics
    (`offline_odometry.cpp:290-302`, `Parameters::ToString`)."""
    with open(path, "w") as f:
        for section, obj in [("radar", cfg.radar), ("filter", cfg.filter),
                             ("feature", cfg.feature),
                             ("registration", cfg.registration),
                             ("odometry", cfg.odometry)]:
            for field in dataclasses.fields(obj):
                f.write(f"{section}.{field.name}, "
                        f"{getattr(obj, field.name)}\n")
        f.write(f"preset, {cfg.name}\n")
        f.write(f"dataset, {args.dataset}\n")
        f.write(f"seed, {args.seed}\n")
        f.write(f"speed, {args.speed}\n")
        f.write(f"n_dynamic, {args.n_dynamic}\n")
        f.write(f"dropout_prob, {args.dropout_prob}\n")
        f.write(f"speckle_burst_prob, {args.speckle_burst_prob}\n")
        for k, v in extra.items():
            f.write(f"{k}, {v}\n")
        f.write(timing.csv() + "\n")


def _profile_stages(cfg, images, timing, device):
    """IN-PIPELINE per-stage timings with the reference's stage names
    ("Filtering" `radar_driver.cpp:87`, "compensate" / "build_normals" /
    "register" `odometrykeyframefuser.cpp:253-256`).

    Runs the REAL sequential pipeline — bootstrap, then per-frame steps
    carrying the true scan state, with the default image ingest — but as
    one function a stage with a device sync after each, so every number is
    the stage's time on the production state (the reference's timing table
    comes from this instrumentation point, `statistics.cpp:31-51`). The
    syncs add a wait the fused step does not pay, which is why this is a
    flag and not always on; `--trace` records the step unsynchronised,
    with the same stage names as `record_function` ranges. "Surface
    points" (cells a frame) and "itrs" (outer registration iterations)
    are documented beside the times."""
    import torch

    from cfear_radarodometry_code_public_tpu_torch.models import odometry
    from cfear_radarodometry_code_public_tpu_torch.ops import (features,
                                                               filtering)
    from cfear_radarodometry_code_public_tpu_torch.utils import se2

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def f_filter(img):
        return filtering.filter_polar_image(
            odometry.upload_images(img[None], dev), cfg)

    def f_comp(xy, tmot):
        return se2.compensate_points(xy, tmot, cfg.radar.ccw)

    def f_cells(pts):
        return features.compute_cells_batched(pts, cfg)

    def f_fuse(state, cells):
        return odometry._fuse_frame(state, cells, cfg)

    # the pipeline's own rule: with time-continuous registration the warp
    # is applied to the cells inside the registration stage
    compensate = cfg.odometry.compensate \
        and not cfg.registration.time_continuous
    bootstrap = odometry.make_bootstrap(cfg, "image", batched=True)
    state, _ = bootstrap(odometry.init_state(cfg, dev, batch=1),
                         odometry.upload_images(images[0][None], dev))
    # warm every stage so one-time costs stay out of the table
    pts_w = f_filter(images[0])
    pts_w = pts_w._replace(xy=f_comp(pts_w.xy, state.tmot))
    f_fuse(state, f_cells(pts_w))[1].pose.cpu()

    for img in images[1:]:
        with timing.timer("Filtering"):
            pts = f_filter(img)
            sync()
        if compensate:
            with timing.timer("compensate"):
                pts = pts._replace(xy=f_comp(pts.xy, state.tmot))
                sync()
        with timing.timer("build_normals"):
            cells = f_cells(pts)
            sync()
        with timing.timer("register"):
            state, out = f_fuse(state, cells)
            sync()
        timing.document("Surface points", float(cells.n[0]))
        timing.document("itrs", float(out.reg_iterations[0]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="synthetic",
                    choices=["synthetic", "oxford", "mulran", "kvarntorp",
                             "volvo"])
    ap.add_argument("--preset", default="CFEAR-3")
    ap.add_argument("--config-file", default=None,
                    help="YAML/JSON config file as the base (overrides "
                         "--preset; flag overrides still apply on top)")
    ap.add_argument("--radar-dir", default=None)
    ap.add_argument("--gt-csv", default=None)
    ap.add_argument("--output-dir", "--est_directory", default="/tmp/cfear_run")
    ap.add_argument("--sequence-name", default="00")
    ap.add_argument("--n-frames", type=int, default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--speed", type=float, default=6.0)
    # adversarial synthetic-world knobs (`datasets/synthetic.py`)
    ap.add_argument("--n-dynamic", type=int, default=0,
                    help="moving objects in the synthetic world")
    ap.add_argument("--dropout-prob", type=float, default=0.0,
                    help="per-frame azimuth-wedge dropout probability")
    ap.add_argument("--speckle-burst-prob", type=float, default=0.0,
                    help="per-frame interference-burst probability")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain twins) instead "
                         "of the CUDA card")
    ap.add_argument("--ingest", choices=("image", "host"), default="image",
                    help="host: native data-plane k-strongest filter on CPU "
                         "threads, only candidate sets cross the device link "
                         "(identical results, ~25x less link traffic)")
    ap.add_argument("--save-graph", dest="save_graph", action="store_true",
                    default=True)
    ap.add_argument("--no-save-graph", dest="save_graph", action="store_false")
    # parameter surface (reference CLI names, `offline_odometry.cpp:150-277`)
    ap.add_argument("--cost_type", default=None)
    ap.add_argument("--loss_type", default=None)
    ap.add_argument("--loss_limit", type=float, default=None)
    ap.add_argument("--weight_option", default=None)
    ap.add_argument("--weight_intensity", type=lambda s: s == "true",
                    default=None)
    ap.add_argument("--res", type=float, default=None)
    ap.add_argument("--k_strongest", type=int, default=None)
    ap.add_argument("--z_min", type=int, default=None)
    ap.add_argument("--z_min_quantile", type=float, default=None,
                    help="adaptive noise-floor threshold: effective z_min "
                         "= max(z_min, per-frame intensity quantile + 1); "
                         "0/off = the reference's fixed z_min. Extends the "
                         "speckle envelope (the fixed detector drowns at "
                         ">= 1.67x the nominal noise floor)")
    ap.add_argument("--filter_type", default=None,
                    choices=[None, "kstrong", "cacfar"])
    # CA-CFAR surface as proper flags (the reference reuses --k_strongest /
    # --covar_scale / --regularization for nb_guard_cells / window_size /
    # false_alarm_rate, `offline_odometry.cpp:260-265` — a hack not worth
    # reproducing)
    ap.add_argument("--cfar_window", type=int, default=None)
    ap.add_argument("--cfar_guard", type=int, default=None)
    ap.add_argument("--false_alarm_rate", type=float, default=None)
    ap.add_argument("--cfar_max_per_azimuth", type=int, default=None)
    ap.add_argument("--submap_scan_size", type=int, default=None)
    ap.add_argument("--min_keyframe_dist", type=float, default=None)
    ap.add_argument("--min_keyframe_rot_deg", type=float, default=None)
    ap.add_argument("--compensate", type=lambda s: s == "true", default=None)
    ap.add_argument("--use_guess", type=lambda s: s == "true", default=None)
    ap.add_argument("--covar_scale", type=float, default=None)
    ap.add_argument("--regularization", type=float, default=None)
    ap.add_argument("--soft_constraint", action="store_true", default=False)
    ap.add_argument("--time_continuous", action="store_true", default=False,
                    help="time-continuous registration: pre-warp source "
                         "cells by the frame velocity at their relative "
                         "scan time (`RegisterTimeContinuous`, "
                         "`n_scan_normal.cpp:67-80`; off by default like "
                         "the reference)")
    ap.add_argument("--disable_registration", action="store_true",
                    default=False,
                    help="pass the motion guess through unrefined "
                         "(`offline_odometry.cpp:214` disable_registration)")
    ap.add_argument("--assoc_radius", type=float, default=None,
                    help="1-NN association gate in meters; doubled on the "
                         "first outer iteration (`registration.h:122`)")
    ap.add_argument("--max_itr_association", type=int, default=None,
                    help="outer association-iteration cap "
                         "(`n_scan_normal.h:75`)")
    ap.add_argument("--max_active_keyframes", type=int, default=None,
                    help="register against only the K keyframes nearest "
                         "the guess pose (0 = all; the s50 speed lever)")
    ap.add_argument("--score_tolerance", type=float, default=None,
                    help="relative score-improvement convergence threshold "
                         "(`n_scan_normal.h:74`)")
    ap.add_argument("--min_assoc_fraction", type=float, default=None,
                    help="divergence gate: fail registration when fewer "
                         "than this fraction of possible associations "
                         "survive (0 disables)")
    ap.add_argument("--max_score", type=float, default=None,
                    help="divergence gate: fail registration when the "
                         "per-residual score exceeds this ceiling")
    ap.add_argument("--estimate_cov_by_sampling", action="store_true",
                    default=False)
    ap.add_argument("--use_raw_pointcloud", action="store_true", default=False)
    ap.add_argument("--max_cells", type=int, default=None)
    ap.add_argument("--point_budget", type=int, default=None,
                    help="feature-stage row-compaction budget (0=off)")
    ap.add_argument("--spatial_sort", action="store_true",
                    help="Morton-order cells (enables the block-sparse "
                         "association kernel on the card for windows >= 8 "
                         "keyframes via assoc_method=auto)")
    ap.add_argument("--profile-stages", action="store_true", default=False,
                    help="in-pipeline per-stage timings (Filtering, "
                         "compensate, build_normals, register) on the "
                         "first 8 frames, a device sync after each stage")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the odometry run "
                         "to DIR/trace.json (Chrome trace format); stage "
                         "names appear as record_function ranges")
    ap.add_argument("--save_radar_img", action="store_true", default=False,
                    help="dump each polar sweep as PNG under "
                         "<output-dir>/radar/ (`offline_odometry.cpp:109-112`)")
    ap.add_argument("--job_nr", type=int, default=None,
                    help="sweep job number: outputs go to "
                         "<output-dir>/job_<n> (`utils/worker` semantics)")
    args = ap.parse_args(argv)
    if args.job_nr is not None:
        args.output_dir = os.path.join(args.output_dir, f"job_{args.job_nr}")

    device = "cpu" if args.cpu else "cuda"

    from cfear_radarodometry_code_public_tpu_torch.eval.kitti import kitti_drift
    from cfear_radarodometry_code_public_tpu_torch.eval.trajectory import (
        ate_rmse, save_trajectories)
    from cfear_radarodometry_code_public_tpu_torch.models import (
        odometry, posegraph)
    from cfear_radarodometry_code_public_tpu_torch.utils.stats import timing

    cfg = build_config(args)
    print(f"config: {cfg.name} dataset={args.dataset} "
          f"cost={cfg.registration.cost} loss={cfg.registration.loss} "
          f"submap={cfg.odometry.submap_scan_size} res={cfg.feature.res} "
          f"k={cfg.filter.k_strongest}", file=sys.stderr)

    with timing.timer("load"):
        images, stamps, gt = load_sequence(args, cfg)
    print(f"loaded {len(images)} frames", file=sys.stderr)

    runner = odometry.OdometryRunner(cfg, chunk=args.chunk,
                                     ingest=args.ingest, device=device)
    t0 = time.perf_counter()
    if args.trace:
        # host and device events of the run, the device's grouped under the
        # program's spans (`utils/trace.py`: the reference's stage names,
        # the feature stages and every host sync)
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if runner.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with timing.timer("odometry-total"):
                runner.process(images)
                traj = runner.trajectory()
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "trace.json"))
    else:
        with timing.timer("odometry-total"):
            runner.process(images)
            traj = runner.trajectory()
    wall = time.perf_counter() - t0
    fps = len(images) / wall
    timing.document("Registration-full", wall * 1e3 / len(images))
    print(f"{len(images)} frames in {wall:.2f}s -> {fps:.1f} fps",
          file=sys.stderr)

    out = runner.frame_outputs()
    os.makedirs(args.output_dir, exist_ok=True)
    if args.save_radar_img:
        # per-frame polar-sweep PNG dump (`offline_odometry.cpp:109-112`
        # writes <nr>.png of the raw radar image)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.image as mpimg
        rdir = os.path.join(args.output_dir, "radar")
        os.makedirs(rdir, exist_ok=True)
        for nr, img in enumerate(images):
            mpimg.imsave(os.path.join(rdir, f"{nr:06d}.png"), img,
                         cmap="gray", vmin=0, vmax=255)
    covs = np.asarray(out.cov)
    save_trajectories(args.output_dir, args.sequence_name, stamps, traj,
                      covs=covs, gt_xyt=gt)

    if args.save_graph:
        # images+cfg attach the per-keyframe RadarScan payload (peaks cloud,
        # filtered cloud, cell map, motion) — the `.sgh` information content
        # the downstream SLAM pass consumes (`types.h:93-143`)
        gb = posegraph.build_graph_from_odometry(out, traj, stamps,
                                                 images=images, cfg=cfg,
                                                 device=device)
        if gt is not None:
            gb.attach_ground_truth(stamps, gt, tol=1e-3)
        gb.save(os.path.join(args.output_dir, "simple_graph.npz"))

    if args.profile_stages:
        _profile_stages(cfg, images[:min(len(images), 8)], timing, device)

    result = {"frames": len(images), "fps": round(fps, 2),
              "keyframes": int(out.fused.sum()),
              "registration_failures": int((~out.success).sum())}
    if gt is not None:
        drift = kitti_drift(traj, gt)
        result.update(t_err_percent=drift["t_err_percent"],
                      r_err_deg_per_m=drift["r_err_deg_per_m"],
                      n_subsequences=drift["n_subsequences"],
                      ate_m=ate_rmse(traj[:, :2], gt[:, :2]))
    with open(os.path.join(args.output_dir, "est", "result.txt"), "w") as f:
        for k, v in result.items():
            f.write(f"{k}: {v}\n")
    write_pars(os.path.join(args.output_dir, "pars.txt"), cfg, args, timing,
               result)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
