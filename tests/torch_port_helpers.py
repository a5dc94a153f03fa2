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
    classes (the port keeps its own copy of config.py)."""
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


def s50_cfg(k_active=0):
    """CFEAR-3-s50 on the small synthetic sensor of `slice_cfg`, cut to a
    12-keyframe window that fills on a short sequence (keyframe gate
    0.5 m), with the block-sparse association; `k_active` is
    `max_active_keyframes`."""
    cfg = ref.preset("CFEAR-3-s50", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=512,
                                    point_budget=2048),
        filter=dataclasses.replace(cfg.filter, k_strongest=12),
        registration=dataclasses.replace(
            cfg.registration, assoc_method="pallas_sparse",
            max_active_keyframes=k_active),
        odometry=dataclasses.replace(cfg.odometry, submap_scan_size=12,
                                     keyframe_min_dist=0.5))
    return both_cfgs(cfg)


def to_jax(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), tree)


def to_torch(tree, cls=None):
    """numpy/JAX NamedTuple -> the port's NamedTuple `cls` of CPU tensors."""
    leaves = [torch.as_tensor(np.array(a)) for a in tree]
    return (cls or type(tree))(*leaves)


def np_tree(tree):
    return [np.asarray(a) for a in tree]


def run_ranks(script: str, n: int, *args, timeout: float = 240.0):
    """Run `script` (Python source) in `n` fresh processes that import the
    port only, as the ranks of one gloo group: each gets argv [rank, n,
    coordinator host:port, *args]. Each rank has `timeout` seconds; on
    expiry every rank is killed and the call fails, so a hung collective
    fails fast. Returns the ranks' outputs (stdout and stderr)."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(n), coord, *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=repo) for r in range(n)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            tails = [q.communicate()[0][-2000:] for q in procs[len(outs):]]
            raise AssertionError(f"a rank outlived {timeout} s:\n"
                                 + "\n".join(tails))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-3000:]}"
    return outs
