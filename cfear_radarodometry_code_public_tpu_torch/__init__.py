"""PyTorch/CUDA port of the CFEAR radar odometry engine.

A second package beside the JAX reference `cfear_radarodometry_code_public_tpu`
(which stays unchanged and is what every module here is tested against). The
layout mirrors the reference (`utils/`, `ops/`, `models/`) with the same
function names. Plain tensor code is PyTorch; the TPU Pallas kernels on the
ported path are hand-written CUDA C++ for Hopper (`csrc/`), each with a plain
PyTorch twin that the CPU runs and the tests compare against.

This package imports `torch` and never `jax`: the framework-free reference
modules (config, synthetic data, native host filter, KITTI drift) are loaded
by file path in `_shared.py`.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry at 100+ m extents does not survive TF32 (about 10 mantissa bits):
# the dense association's |s|^2 + |t|^2 - 2 s.t form would carry
# decimetre-level error. The reference forces 'highest' matmul precision for
# the same reason; here both TF32 switches are turned off explicitly.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from cfear_radarodometry_code_public_tpu_torch._shared import config as _config  # noqa: E402

CFEARConfig = _config.CFEARConfig
FeatureConfig = _config.FeatureConfig
FilterConfig = _config.FilterConfig
OdometryConfig = _config.OdometryConfig
RadarConfig = _config.RadarConfig
RegistrationConfig = _config.RegistrationConfig
preset = _config.preset
