"""Port se2 algebra and robust losses against the JAX reference
(atol 1e-6: f32 sin/cos/atan2 differ between XLA and torch by a few ulp)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import jnp

from cfear_radarodometry_code_public_tpu.ops import losses as jl
from cfear_radarodometry_code_public_tpu.utils import se2 as js
from cfear_radarodometry_code_public_tpu_torch.ops import losses as tl
from cfear_radarodometry_code_public_tpu_torch.utils import se2 as ts

_rng = np.random.default_rng(11)
_A = (_rng.normal(size=(5, 3)) * [10, 10, 2]).astype(np.float32)
_B = (_rng.normal(size=(5, 3)) * [10, 10, 2]).astype(np.float32)
_PTS = (_rng.normal(size=(5, 7, 2)) * 40).astype(np.float32)


def _close(t, j, atol=1e-6, rtol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", ["compose", "relative"])
def test_se2_binary(name):
    _close(getattr(ts, name)(torch.as_tensor(_A), torch.as_tensor(_B)),
           getattr(js, name)(jnp.asarray(_A), jnp.asarray(_B)), atol=1e-5)


@pytest.mark.parametrize("name", ["inverse", "normalize_angle", "rotmat"])
def test_se2_unary(name):
    arg = _A if name == "inverse" else _A[:, 2] * 3
    _close(getattr(ts, name)(torch.as_tensor(arg)),
           getattr(js, name)(jnp.asarray(arg)), atol=1e-5)


@pytest.mark.parametrize("name", ["transform", "rotate"])
def test_se2_apply(name):
    _close(getattr(ts, name)(torch.as_tensor(_A), torch.as_tensor(_PTS)),
           getattr(js, name)(jnp.asarray(_A), jnp.asarray(_PTS)), atol=2e-5)


@pytest.mark.parametrize("ccw", [False, True])
def test_rel_timestamp_and_compensation(ccw):
    tmot = _B * np.float32([0.1, 0.1, 0.02])
    _close(ts.rel_timestamp(torch.as_tensor(_PTS), ccw),
           js.rel_timestamp(jnp.asarray(_PTS), ccw))
    got = ts.compensate_points(torch.as_tensor(_PTS), torch.as_tensor(tmot), ccw)
    want = np.stack([js.compensate_points(jnp.asarray(p), jnp.asarray(t), ccw)
                     for p, t in zip(_PTS, tmot)])
    _close(got, want, atol=2e-5)


@pytest.mark.parametrize("loss", ["None", "Huber", "Cauchy", "SoftLOne",
                                  "Tukey", "Combined", "DCS"])
def test_rho_matches(loss):
    s = np.concatenate([np.float32([0.0, 1e-8, 0.01, 0.0101]),
                        (_rng.random(64) ** 3 * 4).astype(np.float32)])
    for limit in (0.1, 1.0):
        rt, dt = tl.rho(torch.as_tensor(s), loss, limit)
        rj, dj = jl.rho(jnp.asarray(s), loss, limit)
        _close(rt, rj)
        _close(dt, dj)


@pytest.mark.parametrize("opt", ["Uniform", "Sim_N", "Sim_direction",
                                 "Sim_scale", "Combined"])
def test_association_weight_matches(opt):
    n_src, n_tar, p_src, p_tar = (_rng.random((4, 32)) * 20).astype(np.float32)
    sim = _rng.random(32).astype(np.float32)
    args = (n_src, n_tar, sim, p_src, p_tar)
    _close(tl.association_weight(opt, *map(torch.as_tensor, args)),
           jl.association_weight(opt, *map(jnp.asarray, args)))


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        tl.rho(torch.zeros(1), "L7", 1.0)
