"""Kernel F's plain twin (`cuda_lm.lm_solve_fused_plain`) and the LM entry
point (`lm.lm_solve_packed`) on the CPU against the reference's fused
Pallas LM in interpret mode (both variants) and its packed-XLA loop.

The packed problems are `chip_smoke.lm_problem`'s (the slice's association
shapes at a small width: B=3 lanes, N = 2 x 500 rows), made with numpy and
handed to both packages; the JAX side zero-pads N to 1000 -> 1024 for its
lane tiling (zero rows add nothing) and solves lane by lane. Tolerances:
pose atol 1e-4, cost rtol 1e-3, those of the reference's own kernel-vs-XLA
test (`tests/test_registration.py:565-567`): the two packages sum the rows
in another order, which can move an accept or convergence test by an ulp.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import jax, jnp, ref

from cfear_radarodometry_code_public_tpu.ops import pallas_lm
from cfear_radarodometry_code_public_tpu_torch.ops import cuda_lm
from cfear_radarodometry_code_public_tpu_torch.ops import lm as tlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

sys.path.remove(REPO)

COSTS = ("P2P", "P2L", "P2D")
LOSSES = ("Huber", "Cauchy", "Combined", "Tukey", "DCS")
B, S, M, N_PAD = 3, 2, 500, 1024
POSE_TOL, COST_RTOL = 1e-4, 1e-3
_xla = jax.jit(pallas_lm.lm_solve_packed_xla, static_argnames="cfg")


def _problem(cost, loss, seed=0):
    """(reference cfg, port cfg, packed (B, 8, N), pose0 (B, 3)) as numpy;
    loss limit 0.5 m, so every loss keeps the inliers (0.15 m noise)."""
    cfg_t, packed, pose0, _ = chip_smoke.lm_problem(
        np.random.default_rng(seed), B, S, M, cost, loss)
    cfg_t = cfg_t.replace(registration=dataclasses.replace(
        cfg_t.registration, loss_limit=0.5))
    return ref.CFEARConfig.from_dict(cfg_t.to_dict()), cfg_t, packed, pose0


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("cost", COSTS)
def test_twin_matches_reference_kernel_and_xla(cost, loss):
    cfg_j, cfg_t, packed, pose0 = _problem(cost, loss)
    got = tlm.lm_solve_packed(*_torch(packed, pose0), cfg_t)
    # on the CPU the entry point is the twin, for either variant
    for ee in (True, False):
        twin = cuda_lm.lm_solve_fused_plain(*_torch(packed, pose0), cfg_t,
                                            early_exit=ee)
        for a, b in zip(got, twin):
            assert torch.equal(a, b)
    pose_t, cost_t, steps_t, _ = (a.numpy() for a in got)
    assert steps_t.dtype == np.int32 and (steps_t > 0).all()
    padded = np.pad(packed, ((0, 0), (0, 0), (0, N_PAD - packed.shape[2])))
    for i in range(B):
        rows, p0 = jnp.asarray(padded[i]), jnp.asarray(pose0[i])
        refs = {"xla": _xla(rows, p0, cfg=cfg_j)}
        for ee in (True, False):
            refs[f"kernel early_exit={ee}"] = pallas_lm.lm_solve_fused(
                rows, p0, cfg_j, interpret=True, early_exit=ee)
        for name, (p_j, c_j, _, _) in refs.items():
            np.testing.assert_allclose(pose_t[i], np.asarray(p_j),
                                       atol=POSE_TOL, err_msg=f"lane {i} {name}")
            np.testing.assert_allclose(cost_t[i], float(c_j), rtol=COST_RTOL,
                                       err_msg=f"lane {i} {name}")


@pytest.mark.parametrize("cost,loss", [("P2P", "Huber"), ("P2L", "Cauchy")])
@pytest.mark.parametrize("s,m", [(2, 500), (2, 4100)])
def test_twin_matches_xla_at_ragged_widths_and_keeps_an_inf_row(cost, loss,
                                                                 s, m):
    """N = 1,000 and 8,200 (no multiple of a kernel tile: 512 threads, 8
    CTAs), unpadded on both sides. Lanes 0 and 1: pose within 1e-5 of the
    reference's packed-XLA loop (both reach the same minimum; the sums
    differ in order only), accepted steps equal. Lane 2 has a row with
    w = 0 that holds inf: 0 * inf poisons the cost on both sides, no step
    is accepted and the pose stays where it started."""
    cfg_t, packed, pose0, _ = chip_smoke.lm_problem(
        np.random.default_rng(7), B, s, m, cost, loss)
    cfg_j = ref.CFEARConfig.from_dict(cfg_t.to_dict())
    assert packed.shape[2] in (1000, 8200)
    packed[2, 2, 17] = np.inf
    packed[2, 4, 17] = 0.0
    pose_t, cost_t, steps_t, _ = (a.numpy() for a in cuda_lm.lm_solve_fused(
        *_torch(packed, pose0), cfg_t))
    for i in range(B):
        p_j, c_j, steps_j, _ = _xla(jnp.asarray(packed[i]),
                                    jnp.asarray(pose0[i]), cfg=cfg_j)
        assert steps_t[i] == int(steps_j), f"lane {i}"
        if i < 2:
            assert steps_t[i] > 0
            np.testing.assert_allclose(pose_t[i], np.asarray(p_j), atol=1e-5,
                                       err_msg=f"lane {i}")
            np.testing.assert_allclose(cost_t[i], float(c_j), rtol=COST_RTOL)
        else:
            assert steps_t[i] == 0 and not np.isfinite(cost_t[i])
            assert not np.isfinite(float(c_j))
            np.testing.assert_array_equal(pose_t[i], pose0[i])
            np.testing.assert_array_equal(np.asarray(p_j), pose0[i])


def test_lanes_are_independent():
    """A lane of a batched solve equals the same lane solved alone."""
    _, cfg_t, packed, pose0 = _problem("P2D", "Cauchy", seed=3)
    batched = tlm.lm_solve_packed(*_torch(packed, pose0), cfg_t)
    for i in range(B):
        alone = tlm.lm_solve_packed(*_torch(packed[i:i + 1], pose0[i:i + 1]),
                                    cfg_t)
        for a, b in zip(batched, alone):
            np.testing.assert_allclose(a[i].numpy(), b[0].numpy(), rtol=1e-6,
                                       atol=1e-7)


def test_entry_point_keeps_pose_dtype():
    _, cfg_t, packed, pose0 = _problem("P2P", "Huber")
    pose, cost, steps, rel = tlm.lm_solve_packed(
        torch.as_tensor(packed), torch.as_tensor(pose0).double(), cfg_t)
    assert pose.dtype == torch.float64 and pose.shape == (B, 3)
    assert cost.shape == rel.shape == (B,) and steps.dtype == torch.int32


@pytest.mark.parametrize("bad", ["dtype", "shape", "pose_shape", "strides",
                                 "loss"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, cfg_t, packed, pose0 = _problem("P2P", "Huber")
    packed, pose0 = _torch(packed, pose0)
    err = ValueError
    if bad == "dtype":
        packed, err = packed.double(), TypeError
    elif bad == "shape":
        packed = packed[:, :7].contiguous()
    elif bad == "pose_shape":
        pose0 = pose0[:2]
    elif bad == "strides":
        packed = packed.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        cfg_t = cfg_t.replace(registration=dataclasses.replace(
            cfg_t.registration, loss="Welsch"))
    with pytest.raises(err):
        cuda_lm.lm_solve_fused(packed, pose0, cfg_t)
    assert cuda_lm.launches["lm_solve_fused"] == 0


def test_no_port_code_forces_the_launch_hook():
    """`cuda_lm._launch(cluster=, smem_rows=)` is for measurements and
    tests: inside the package only `lm_solve_fused` calls it, and leaves
    both at 0 (the kernel's own choice from N)."""
    import re
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(cuda_lm.__file__)))
    found = []
    for top, _, files in os.walk(pkg):
        for name in (n for n in files if n.endswith(".py")):
            with open(os.path.join(top, name)) as f:
                text = f.read()
            found += [(name, hit) for hit in re.findall(
                r"cuda_lm\._launch|[(,]\s*(?:cluster|smem_rows)=", text)]
            if name == "cuda_lm.py":
                calls = re.findall(r"(?<!def )_launch\(([^)]*)\)", text)
    assert calls == ["packed, pose0, cfg, early_exit"]
    assert found == []
