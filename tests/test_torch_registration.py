"""Port registration and LM against the JAX reference on identical cells.

The cells are built once by the reference's feature stage and handed to both
packages, so the comparison isolates the association, the LM and the outer
loop. Tolerances: poses within 1e-5 (f32 sums taken in another order than
XLA's); association counts, outer iterations and success flags exact.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs, jnp, to_torch
from test_registration import _cells_from_world, _cfg, _stack_keyframes, _world_cloud

from cfear_radarodometry_code_public_tpu.ops import pallas_lm
from cfear_radarodometry_code_public_tpu.ops import registration as jreg
from cfear_radarodometry_code_public_tpu_torch.ops import lm as tlm
from cfear_radarodometry_code_public_tpu_torch.ops import registration as treg
from cfear_radarodometry_code_public_tpu_torch.ops.features import CellMap


def _problem(cost, method, seed=7, n_kf=3, max_cells=512):
    """A registration problem (JAX cells + port config) at a known pose."""
    cfg = _cfg(cost, "Huber", "Combined", max_cells=max_cells)
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature,
                                    spatial_sort=method == "pallas_sparse"),
        registration=dataclasses.replace(cfg.registration,
                                         assoc_method=method))
    rng = np.random.default_rng(seed)
    xy, intens = _world_cloud(rng)
    true = np.array([2.5, 0.8, 0.06])
    kf_poses = np.stack([np.array([0.4, 0.1, 0.01]) * i for i in range(n_kf)])
    kf_cells = _stack_keyframes(
        [_cells_from_world(xy, intens, p, cfg) for p in kf_poses])
    src = _cells_from_world(xy, intens, true, cfg)
    guess = (true + np.array([0.3, -0.2, 0.02])).astype(np.float32)
    return cfg, kf_cells, kf_poses.astype(np.float32), src, guess


def _lane(tree):
    """JAX CellMap -> port CellMap with a leading lane axis."""
    return CellMap(*(t[None] for t in to_torch(tree, CellMap)))


def _port_register(cfg_t, kf_cells, kf_poses, src, guess, kf_valid):
    return treg.register(_lane(kf_cells), torch.as_tensor(kf_poses)[None],
                         torch.as_tensor(kf_valid)[None], _lane(src),
                         torch.as_tensor(guess)[None], cfg=cfg_t)


@pytest.mark.parametrize("cost,method", [
    ("P2P", "pallas"), ("P2L", "pallas"), ("P2D", "pallas"),
    ("P2P", "pallas_sparse"), ("P2L", "dense")])
def test_register_matches_jax(cost, method):
    cfg, kf_cells, kf_poses, src, guess = _problem(cost, method)
    kf_valid = np.ones(len(kf_poses), bool)
    r_j = jreg.register(kf_cells, jnp.asarray(kf_poses), jnp.asarray(kf_valid),
                        src, jnp.asarray(guess), cfg=cfg)
    _, cfg_t = both_cfgs(cfg)
    r_t = _port_register(cfg_t, kf_cells, kf_poses, src, guess, kf_valid)
    assert bool(r_j.success)
    np.testing.assert_allclose(r_t.pose[0].numpy(), np.asarray(r_j.pose),
                               atol=1e-5)
    for f in ("num_assoc", "iterations", "success"):
        assert getattr(r_t, f)[0].item() == np.asarray(getattr(r_j, f)).item(), f
    np.testing.assert_allclose(r_t.score[0].item(), float(r_j.score),
                               rtol=1e-4)
    np.testing.assert_allclose(r_t.cov[0].numpy(), np.asarray(r_j.cov),
                               rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("cost", ["P2P", "P2L", "P2D"])
def test_lm_solve_packed_matches_xla(cost):
    cfg, kf_cells, kf_poses, src, guess = _problem(cost, "pallas", n_kf=2)
    kf_valid = jnp.ones(len(kf_poses), bool)
    attrs = jreg._world_attrs(kf_cells, jnp.asarray(kf_poses), cfg)
    assoc, tgt = jreg._associate_world(
        attrs, src, jnp.asarray(guess), kf_valid,
        2.0 * cfg.registration.assoc_radius, cfg,
        math.cos(math.radians(cfg.registration.angle_outlier_deg)), "pallas")
    packed = pallas_lm.pack_associations(src.mean, tgt,
                                         assoc.weight * assoc.valid, cfg)
    p_j, c_j, s_j, l_j = pallas_lm.lm_solve_packed_xla(packed,
                                                       jnp.asarray(guess), cfg)
    _, cfg_t = both_cfgs(cfg)
    n = np.asarray(assoc.weight).size
    p_t, c_t, s_t, l_t = tlm.lm_solve_packed(
        torch.as_tensor(np.array(packed)[:, :n])[None],
        torch.as_tensor(guess)[None], cfg_t)
    np.testing.assert_allclose(p_t[0].numpy(), np.asarray(p_j), atol=1e-5)
    np.testing.assert_allclose(c_t[0].item(), float(c_j), rtol=1e-5)
    assert s_t[0].item() == int(s_j)


def test_pack_associations_matches_jax():
    cfg, kf_cells, kf_poses, src, guess = _problem("P2D", "pallas", n_kf=2)
    attrs = jreg._world_attrs(kf_cells, jnp.asarray(kf_poses), cfg)
    assoc, tgt = jreg._associate_world(
        attrs, src, jnp.asarray(guess), jnp.ones(2, bool), 4.0, cfg,
        math.cos(math.radians(30.0)), "pallas")
    packed = np.asarray(pallas_lm.pack_associations(
        src.mean, tgt, assoc.weight * assoc.valid, cfg))
    _, cfg_t = both_cfgs(cfg)
    tgt_t = {k: torch.as_tensor(np.array(v))[None] for k, v in tgt.items()}
    w = torch.as_tensor(np.array(assoc.weight * assoc.valid))[None]
    got = tlm.pack_associations(torch.as_tensor(np.array(src.mean))[None],
                                tgt_t, w, cfg_t)
    np.testing.assert_array_equal(got[0].numpy(), packed[:, :w[0].numel()])


def test_register_batched_equals_per_lane():
    """Lanes of one batched register() equal separate single-lane calls,
    including a lane whose outer loop finishes earlier than the others."""
    cfg, kf_cells, kf_poses, src, guess = _problem("P2P", "pallas")
    _, cfg_t = both_cfgs(cfg)
    guesses = np.stack([guess, guess + np.float32([0.2, 0.1, -0.01]),
                        guess - np.float32([0.5, 0.3, 0.02])])
    kf_valid = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], bool)
    b = len(guesses)
    kfc = CellMap(*(torch.as_tensor(np.array(t))[None].expand(
        (b,) + t.shape).contiguous() for t in kf_cells))
    srcb = CellMap(*(torch.as_tensor(np.array(t))[None].expand(
        (b,) + t.shape).contiguous() for t in src))
    r_b = treg.register(kfc, torch.as_tensor(kf_poses)[None].expand(b, -1, -1),
                        torch.as_tensor(kf_valid), srcb,
                        torch.as_tensor(guesses), cfg=cfg_t)
    for i in range(b):
        r_1 = _port_register(cfg_t, kf_cells, kf_poses, src, guesses[i],
                             kf_valid[i])
        for f in r_b._fields:
            np.testing.assert_allclose(getattr(r_b, f)[i].numpy(),
                                       getattr(r_1, f)[0].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
    assert len(set(r_b.iterations.tolist())) > 1


@pytest.mark.parametrize("option,value", [
    ("soft_constraint", True), ("time_continuous", True),
    ("assoc_method", "grid")])
def test_unported_registration_options_raise(option, value):
    cfg, kf_cells, kf_poses, src, guess = _problem("P2P", "pallas", n_kf=1)
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, **{option: value}))
    _, cfg_t = both_cfgs(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_register(cfg_t, kf_cells, kf_poses, src, guess,
                       np.ones(1, bool))


def test_resolve_assoc_method_policy():
    cfg = both_cfgs(_cfg("P2P"))[1]
    sorted_cfg = cfg.replace(feature=dataclasses.replace(
        cfg.feature, spatial_sort=True))
    assert treg.resolve_assoc_method(cfg, 1024, 1024, 4, "cpu") == "dense"
    assert treg.resolve_assoc_method(cfg, 1024, 1024, 4, "cuda") == "pallas"
    assert treg.resolve_assoc_method(sorted_cfg, 1024, 1024, 8,
                                     "cuda") == "pallas_sparse"
    assert treg.resolve_assoc_method(cfg, 1000, 1000, 4, "cuda") == "dense"


def test_active_window_matches_jax():
    """`max_active_keyframes`: the K keyframes nearest the guess, in the
    reference's top_k order (ties by index), then the same solve."""
    cfg, kf_cells, kf_poses, src, guess = _problem("P2P", "pallas", n_kf=6)
    kf_poses[4] = kf_poses[1]                    # a distance tie
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, max_active_keyframes=3))
    _, cfg_t = both_cfgs(cfg)
    kf_valid = np.array([1, 1, 0, 1, 1, 1], bool)
    j_cells, j_poses, j_valid = jreg._active_window(
        kf_cells, jnp.asarray(kf_poses), jnp.asarray(kf_valid),
        jnp.asarray(guess), cfg)
    t_cells, t_poses, t_valid = treg._active_window(
        _lane(kf_cells), torch.as_tensor(kf_poses)[None],
        torch.as_tensor(kf_valid)[None], torch.as_tensor(guess)[None], cfg_t)
    np.testing.assert_array_equal(t_poses[0].numpy(), np.asarray(j_poses))
    np.testing.assert_array_equal(t_valid[0].numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_cells.mean[0].numpy(),
                                  np.asarray(j_cells.mean))
    r_j = jreg.register(kf_cells, jnp.asarray(kf_poses), jnp.asarray(kf_valid),
                        src, jnp.asarray(guess), cfg=cfg)
    r_t = _port_register(cfg_t, kf_cells, kf_poses, src, guess, kf_valid)
    np.testing.assert_allclose(r_t.pose[0].numpy(), np.asarray(r_j.pose),
                               atol=1e-5)
    assert r_t.num_assoc[0].item() == int(r_j.num_assoc)


def test_disable_registration_echoes_the_guess():
    cfg, kf_cells, kf_poses, src, guess = _problem("P2P", "pallas", n_kf=1)
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, disable_registration=True))
    _, cfg_t = both_cfgs(cfg)
    r_j = jreg.register(kf_cells, jnp.asarray(kf_poses), jnp.ones(1, bool),
                        src, jnp.asarray(guess), cfg=cfg)
    r_t = _port_register(cfg_t, kf_cells, kf_poses, src, guess,
                         np.ones(1, bool))
    for f in r_t._fields:
        np.testing.assert_array_equal(getattr(r_t, f)[0].numpy(),
                                      np.asarray(getattr(r_j, f)), err_msg=f)
