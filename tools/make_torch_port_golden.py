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
  `chip_smoke.LONGRUN_ADV8_SEQUENCE` (`cfear3_longrun_adv_seed11_256_8ms.npz`).
  The configuration keeps the preset's `assoc_method="auto"`, which
  resolves to kernel A on a card; the reference runs it as
  `assoc_method="pallas"` (kernel A in interpret mode), and the file also
  holds the health fields and the KITTI drift.

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --feature-backend pallas
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset CFEAR-3-s50
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset CFEAR-3-s50 --k-active 16
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset longrun
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset longrun --adversarial --speed 8

On one CPU process the first takes about 10 s and the second about a
minute; the s50 exact golden took 39 s and the K16 golden 18 s (rendering
of the 128 frames excluded); each longrun golden about a minute.

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

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from cfear_radarodometry_code_public_tpu.config import CFEARConfig  # noqa: E402
from cfear_radarodometry_code_public_tpu.datasets import synthetic  # noqa: E402
from cfear_radarodometry_code_public_tpu.eval.kitti import kitti_drift  # noqa: E402
from cfear_radarodometry_code_public_tpu.eval.trajectory import ate_rmse  # noqa: E402
from cfear_radarodometry_code_public_tpu.models.odometry import OdometryRunner  # noqa: E402


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
    ap.add_argument("--preset", choices=("CFEAR-3", "CFEAR-3-s50", "longrun"),
                    default="CFEAR-3")
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
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
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
