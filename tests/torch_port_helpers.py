"""Shared helpers for the PyTorch-port tests (tests/test_torch_*.py).

Importing this module sets torch to one thread: the suite runs under
pytest-xdist with several workers on few cores. Inputs are made with numpy
and handed to both packages; outputs are compared as numpy arrays.
"""

import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cfear_radarodometry_code_public_tpu as ref  # noqa: E402
import cfear_radarodometry_code_public_tpu_torch as port  # noqa: E402


def both_cfgs(cfg_ref):
    """The same configuration as the reference's and the port's config
    classes (the port loads config.py as its own module)."""
    return cfg_ref, port.CFEARConfig.from_dict(cfg_ref.to_dict())


def slice_cfg(**feature):
    """The small synthetic CFEAR-3 configuration of tests/test_odometry.py
    with a point budget (host compact ingest)."""
    cfg = ref.preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=512,
                                    point_budget=2048, **feature),
        filter=dataclasses.replace(cfg.filter, k_strongest=12))
    return both_cfgs(cfg)


def to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), tree)


def to_torch(tree, cls=None):
    """numpy/JAX NamedTuple -> the port's NamedTuple `cls` of CPU tensors."""
    leaves = [torch.as_tensor(np.array(a)) for a in tree]
    return (cls or type(tree))(*leaves)


def np_tree(tree):
    return [np.asarray(a) for a in tree]
