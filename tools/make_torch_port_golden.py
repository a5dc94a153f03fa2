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

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --feature-backend pallas
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset CFEAR-3-s50
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --preset CFEAR-3-s50 --k-active 16

On one CPU process the first takes about 10 s and the second about a
minute; the s50 exact golden took 39 s and the K16 golden 18 s (rendering
of the 128 frames excluded).

With `--assoc-method dense` the tool runs the same configuration with the
reference's dense association instead, writes nothing, and prints that
run's spread from the committed golden (max per pose, yaw and
frame-to-frame motion, and whether the keyframe decisions agree): the
reference's own spread between its two association backends, on which
`chip_smoke.TOL` and `chip_smoke.S50_TOL` are set at about 3x.

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
from cfear_radarodometry_code_public_tpu.eval.trajectory import ate_rmse  # noqa: E402
from cfear_radarodometry_code_public_tpu.models.odometry import OdometryRunner  # noqa: E402


def target(preset: str, feature_backend: str, k_active: int):
    """(configuration, sequence, output path) of one golden."""
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
    ap.add_argument("--preset", choices=("CFEAR-3", "CFEAR-3-s50"),
                    default="CFEAR-3")
    ap.add_argument("--feature-backend", choices=("auto", "pallas"),
                    default="auto")
    ap.add_argument("--k-active", type=int, default=0)
    ap.add_argument("--assoc-method", choices=("pallas_sparse", "dense"),
                    default="pallas_sparse")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    port_cfg, sequence, path = target(args.preset, args.feature_backend,
                                      args.k_active)
    if args.assoc_method == "dense":
        port_cfg = port_cfg.replace(registration=dataclasses.replace(
            port_cfg.registration, assoc_method="dense"))
    cfg_dict = port_cfg.to_dict()
    cfg = CFEARConfig.from_dict(cfg_dict)
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
    if args.assoc_method == "dense":
        with np.load(path) as z:
            g_poses, g_fused = z["poses"], z["fused"]
        dpos, dyaw, dmot = chip_smoke.traj_spread(traj, g_poses)
        print(f"dense vs {os.path.basename(path)}: max |dpos| {dpos:.6f} m, "
              f"|dyaw| {dyaw:.3e} rad, |dmotion| {dmot:.6f} m; keyframe "
              f"flags equal {bool(np.array_equal(out.fused, g_fused))}; "
              f"ATE {ate:.4f} m, all successful {bool(out.success.all())}, "
              f"{time.perf_counter() - t0:.1f} s on the CPU")
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, poses=traj, gt=gt, fused=out.fused,
        success=out.success, num_assoc=out.num_assoc,
        num_cells=out.num_cells, ate=np.float64(ate),
        config=json.dumps(cfg_dict), sequence=json.dumps(sequence))
    print(f"{path}: {images.shape[0]} frames, ATE {ate:.4f} m, "
          f"keyframes {int(out.fused.sum())}, all successful "
          f"{bool(out.success.all())}, {time.perf_counter() - t0:.1f} s "
          f"on the CPU")


if __name__ == "__main__":
    main()
