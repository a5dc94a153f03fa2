"""Write the JAX golden trajectories that `chip_smoke.py` holds the PyTorch
port against.

Runs the JAX reference on the CPU over chip_smoke's exact sequence
(`synthetic.make_sequence(**chip_smoke.SEQUENCE)`, Oxford sensor scale) and
configuration (`chip_smoke.slice_config()`: CFEAR-3 with the bench
settings, `assoc_method="pallas_sparse"`, so the block-sparse Pallas kernel
runs in interpret mode with the arithmetic of the port's kernel C), and
writes poses, keyframe and success flags, association counts, the ATE
against ground truth, and the configuration and sequence as JSON to
`cfear_radarodometry_code_public_tpu_torch/golden/cfear3_oxford_seed1_64.npz`.
With `--feature-backend pallas` the configuration also sets
`feature.backend="pallas"` (the moment kernel runs in interpret mode) and
the file is `golden/cfear3_oxford_seed1_64_pallasfeat.npz`.

    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py
    JAX_PLATFORMS=cpu python tools/make_torch_port_golden.py --feature-backend pallas

The first takes seconds on one CPU process, the second about a minute.
"""

from __future__ import annotations

import argparse
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--feature-backend", choices=("auto", "pallas"),
                    default="auto")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.feature_backend == "pallas":
        cfg_dict = chip_smoke.slice_config(feature_backend="pallas").to_dict()
        path = chip_smoke.GOLDEN_PALLAS
    else:
        cfg_dict = chip_smoke.slice_config().to_dict()
        path = chip_smoke.GOLDEN
    cfg = CFEARConfig.from_dict(cfg_dict)
    images, gt = synthetic.make_sequence(cfg=cfg, **chip_smoke.SEQUENCE)
    t0 = time.perf_counter()
    # one chunk size that divides the frames after the bootstrap frame, so
    # the reference compiles no ragged-tail step
    runner = OdometryRunner(cfg, chunk=(images.shape[0] - 1) // 3,
                            ingest="host")
    runner.process(images)
    traj = runner.trajectory()
    out = runner.frame_outputs()
    ate = ate_rmse(traj[:, :2], gt[:, :2])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path, poses=traj, gt=gt, fused=out.fused,
        success=out.success, num_assoc=out.num_assoc,
        num_cells=out.num_cells, ate=np.float64(ate),
        config=json.dumps(cfg_dict), sequence=json.dumps(chip_smoke.SEQUENCE))
    print(f"{path}: {images.shape[0]} frames, ATE {ate:.4f} m, "
          f"keyframes {int(out.fused.sum())}, all successful "
          f"{bool(out.success.all())}, {time.perf_counter() - t0:.1f} s "
          f"on the CPU")


if __name__ == "__main__":
    main()
