"""Port registration and LM against the JAX reference on identical cells.

The cells are built once by the reference's feature stage and handed to both
packages, so the comparison isolates the association, the LM and the outer
loop. Tolerances: poses within 1e-5 (f32 sums taken in another order than
XLA's); association counts, outer iterations and success flags exact.
The cost-evaluation entry points: costs within 1e-5 relative, residual
counts exact; the sampled covariance within 1e-3 relative of its largest
entry (the port fits the quadratic in float64, the reference in float32)
and the convexity flag exact.
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


def _solve64(rows64, guess, cfg_t, steps):
    """The port's plain LM loop in float64 on the same packed rows, stopped
    after its `steps`-th accepted step (the iteration cap raised until the
    solve has taken that many, or to the config's own limit)."""
    g = torch.as_tensor(guess, dtype=torch.float64)[None]
    for itr in range(steps, cfg_t.registration.max_itr_solver + 1):
        c = cfg_t.replace(registration=dataclasses.replace(
            cfg_t.registration, max_itr_solver=itr))
        out = tlm._lm_core(rows64, g[:, 0], g[:, 1], g[:, 2], c)
        if out[4].item() >= steps:
            break
    return torch.stack(out[:3], -1)[0].numpy(), out[3].item(), out[4].item()


@pytest.mark.parametrize("cost", ["P2P", "P2L", "P2D"])
def test_lm_solve_packed_matches_xla(cost):
    """The port's packed LM solve against the reference's XLA solve on the
    same rows: poses within 1e-5, costs within 1e-5 relative, equal step
    counts, and the port's pose within 1e-5 of a float64 solve that took as
    many steps.

    The step counts may differ by one step only where that step's decision
    lies within float32 rounding: its true (float64) cost decrease must be
    below 1e-5 of the cost, the resolution at which a float32 sum over these
    world-frame residuals places the cost. On the P2L case the final step
    lowers the float64 cost by 5.6e-7 of 0.709 (8e-7 relative), while the
    float32 cost itself is off its float64 value by up to 4e-6 in the port
    and 8e-7 in the reference run op by op: the reference's compiled solve
    takes that step (4 steps), its op-by-op run and the port do not (3).
    There both solves are then held to each other with their iteration
    limit set to the smaller step count."""
    cfg, kf_cells, kf_poses, src, guess = _problem(cost, "pallas", n_kf=2)
    kf_valid = jnp.ones(len(kf_poses), bool)
    attrs = jreg._world_attrs(kf_cells, jnp.asarray(kf_poses), cfg)
    assoc, tgt = jreg._associate_world(
        attrs, src, jnp.asarray(guess), kf_valid,
        2.0 * cfg.registration.assoc_radius, cfg,
        math.cos(math.radians(cfg.registration.angle_outlier_deg)), "pallas")
    packed = pallas_lm.pack_associations(src.mean, tgt,
                                         assoc.weight * assoc.valid, cfg)
    _, cfg_t = both_cfgs(cfg)
    n = np.asarray(assoc.weight).size
    rows = torch.as_tensor(np.array(packed)[:, :n])[None]

    def solve_both(c_ref, c_port):
        p_j, c_j, s_j, _ = pallas_lm.lm_solve_packed_xla(
            packed, jnp.asarray(guess), c_ref)
        p_t, c_t, s_t, _ = tlm.lm_solve_packed(
            rows, torch.as_tensor(guess)[None], c_port)
        return (np.asarray(p_j), float(c_j), int(s_j),
                p_t[0].numpy(), c_t[0].item(), s_t[0].item())

    p_j, c_j, s_j, p_t, c_t, s_t = solve_both(cfg, cfg_t)
    rows64 = tuple(rows.double()[:, i] for i in range(8))
    p64, c64, s64 = _solve64(rows64, guess, cfg_t, s_t)
    assert s64 == s_t
    np.testing.assert_allclose(p_t, p64, atol=1e-5)
    if s_t != s_j:
        lo = min(s_t, s_j)
        assert max(s_t, s_j) == lo + 1
        _, c_lo, _ = _solve64(rows64, guess, cfg_t, lo)
        _, c_hi, s_hi = _solve64(rows64, guess, cfg_t, lo + 1)
        assert s_hi == lo + 1
        assert 0.0 <= c_lo - c_hi < 1e-5 * c_lo
        capped = cfg.replace(registration=dataclasses.replace(
            cfg.registration, max_itr_solver=lo))
        p_j, c_j, s_j, p_t, c_t, s_t = solve_both(*both_cfgs(capped))
        assert s_j == lo
    np.testing.assert_allclose(p_t, p_j, atol=1e-5)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5)
    assert s_t == s_j


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


@pytest.mark.parametrize("option,value", [("assoc_method", "grid")])
def test_unported_registration_options_raise(option, value):
    """Every registration option is ported now: `assoc_method="grid"` (the
    last one) registers as the reference's grid does, and an unknown method
    raises."""
    cfg, kf_cells, kf_poses, src, guess = _problem("P2P", "pallas", n_kf=1)
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, **{option: value}))
    _, cfg_t = both_cfgs(cfg)
    kf_valid = np.ones(1, bool)
    r_t = _port_register(cfg_t, kf_cells, kf_poses, src, guess, kf_valid)
    r_j = jreg.register(kf_cells, jnp.asarray(kf_poses),
                        jnp.asarray(kf_valid), src, jnp.asarray(guess),
                        cfg=cfg)
    assert bool(r_j.success) and r_t.success.item()
    np.testing.assert_allclose(r_t.pose[0].numpy(), np.asarray(r_j.pose),
                               atol=1e-5)
    bad = cfg_t.replace(registration=dataclasses.replace(
        cfg_t.registration, assoc_method="octree"))
    with pytest.raises(ValueError, match="octree"):
        _port_register(bad, kf_cells, kf_poses, src, guess, kf_valid)


def _grid_problem(cost="P2L", seed=7):
    """`tests/test_registration.py:197`: one world seen from the origin and
    from a second keyframe pose, the source from (1.2, 0.7, 0.05); the
    reference's grid and dense configurations and the port's."""
    cfg_g = _cfg(cost)
    cfg_g = cfg_g.replace(registration=dataclasses.replace(
        cfg_g.registration, assoc_method="grid"))
    cfg_d = cfg_g.replace(registration=dataclasses.replace(
        cfg_g.registration, assoc_method="dense"))
    rng = np.random.default_rng(seed)
    xy, intens = _world_cloud(rng)
    kf_poses = np.array([[0, 0, 0], [0.5, 0.2, 0.02]], np.float32)
    kf = _stack_keyframes([_cells_from_world(xy, intens, p, cfg_g)
                           for p in kf_poses])
    src = _cells_from_world(xy, intens, np.array([1.2, 0.7, 0.05]), cfg_g)
    return cfg_g, cfg_d, kf, kf_poses, src


def test_grid_buckets_equal_the_reference():
    """The bucket tables of both keyframes equal the reference's slot for
    slot (the stable sort ranks a bucket's cells by index); the overflow
    sink is -1 in the port, and the reference's holds an invalid cell."""
    cfg_g, _, kf, _, _ = _grid_problem()
    cfg_t = both_cfgs(cfg_g)[1]
    assert treg._bucket_geometry(cfg_t) == jreg._bucket_geometry(cfg_g)
    got = treg.build_buckets(_lane(kf), cfg_t)[0].numpy()
    for i in range(2):
        one = jax_tree_index(kf, i)
        want = np.asarray(jreg.build_buckets(one, cfg_g))
        np.testing.assert_array_equal(got[i, :-1], want[:-1])
        assert got[i, -1] == -1 and not bool(one.valid[want[-1]])
        assert (want[:-1] >= 0).sum() == int(np.asarray(one.valid).sum())


def test_grid_buckets_under_overflow_equal_the_reference():
    """At Oxford width (the CFEAR-3 Oxford preset, 3072 cells) with buckets
    crowded past `bucket_capacity`, cells outside the grid and invalid
    cells: the port's table equals the reference's slot for slot below the
    sink, and both equal `chip_smoke.grid_reference_table`, the numpy
    table the smoke's `cli-grid` path holds the card's against (the port's
    overflow rows go to a dump slot past the sink, which must not leak)."""
    import os
    import sys
    from cfear_radarodometry_code_public_tpu.config import preset
    from cfear_radarodometry_code_public_tpu.ops.features import (
        CellMap as JCellMap)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    cfg_j = preset("CFEAR-3", dataset="oxford")
    cfg_j = cfg_j.replace(registration=dataclasses.replace(
        cfg_j.registration, assoc_method="grid"))
    cfg_t = both_cfgs(cfg_j)[1]
    bin_size, g = treg._bucket_geometry(cfg_t)
    cap = cfg_t.registration.bucket_capacity
    rng = np.random.default_rng(11)
    m = cfg_t.feature.max_cells
    mean = (rng.uniform(-1, 1, (m, 2)) * 0.45 * g * bin_size).astype(
        np.float32)
    crowd = rng.integers(0, 5, 600)          # 600 cells in 5 buckets
    mean[:600] = (rng.uniform(0.1, 0.9, (600, 2)) + crowd[:, None] * 3) \
        .astype(np.float32) * np.float32(bin_size)
    mean[600:640] = np.float32(0.6 * g * bin_size)       # outside the grid
    valid = rng.random(m) < 0.9
    z = np.zeros((m,), np.float32)
    cells = JCellMap(mean=jnp.asarray(mean), normal=jnp.asarray(mean),
                     cov=jnp.zeros((m, 2, 2)), nsamples=jnp.asarray(z),
                     planarity=jnp.asarray(z), valid=jnp.asarray(valid))
    want = np.asarray(jreg.build_buckets(cells, cfg_j))
    port = CellMap(*(torch.as_tensor(np.array(a))[None] for a in cells))
    got = treg.build_buckets(port, cfg_t)[0].numpy()
    table = chip_smoke.grid_reference_table(mean, valid, cfg_t)
    np.testing.assert_array_equal(got[:-1], want[:-1])
    np.testing.assert_array_equal(table, want[:-1])
    assert got[-1] == -1
    full = (table.reshape(g * g, cap) >= 0).all(-1).sum()
    assert full >= 5 and (table >= 0).sum() < valid.sum() - 40


def jax_tree_index(tree, i):
    return type(tree)(*(a[i] for a in tree))


@pytest.mark.parametrize("radius", [2.0, 4.0])
def test_grid_association_matches_the_reference_and_dense(radius):
    """`associate` with the grid: target indices, validity and weights of
    both keyframes equal the reference's grid and the port's own dense
    association (`tests/test_registration.py:197-216`)."""
    cfg_g, cfg_d, kf, kf_poses, src = _grid_problem()
    pose = np.array([1.2, 0.7, 0.05], np.float32)
    got = {}
    for name, cfg in (("grid", cfg_g), ("dense", cfg_d)):
        got[name] = treg.associate(
            _lane(kf), torch.as_tensor(kf_poses)[None],
            torch.ones(1, 2, dtype=torch.bool), _lane(src),
            torch.as_tensor(pose)[None], radius, both_cfgs(cfg)[1])
    want = jreg.associate(kf, jnp.asarray(kf_poses), jnp.ones(2, bool), src,
                          jnp.asarray(pose), radius, cfg_g)
    v = np.asarray(want.valid)
    assert v.sum() > 100
    for a in (got["grid"], got["dense"]):
        np.testing.assert_array_equal(a.valid[0].numpy(), v)
        np.testing.assert_array_equal(a.tar_idx[0].numpy()[v],
                                      np.asarray(want.tar_idx)[v])
        np.testing.assert_allclose(a.weight[0].numpy(),
                                   np.asarray(want.weight), atol=1e-6)


@pytest.mark.parametrize("cost", ["P2P", "P2L", "P2D"])
def test_grid_register_matches_the_reference_and_dense(cost):
    """`register` with the grid from a guess off the true pose: the port's
    grid solve within 1e-5 of its own dense association's (the grid takes
    the normal agreement in the keyframe's frame, the world form in the
    world's: weights an ulp apart), with equal association counts and
    outer iterations, as the reference's grid and dense are; against the
    reference's grid solve, no farther than the port's dense solve is from
    the reference's dense solve, plus 1e-5 (on this P2L problem both are
    1e-4 apart: an LM step decided within f32 rounding, whatever the
    association; ROADMAP queue 3). `get_cost` with the grid equals
    the reference's within 1e-5 relative."""
    cfg_g, cfg_d, kf, kf_poses, src = _grid_problem(cost)
    guess = np.array([1.4, 0.5, 0.03], np.float32)
    kf_valid = np.ones(2, bool)
    r_g = _port_register(both_cfgs(cfg_g)[1], kf, kf_poses, src, guess,
                         kf_valid)
    r_d = _port_register(both_cfgs(cfg_d)[1], kf, kf_poses, src, guess,
                         kf_valid)
    np.testing.assert_allclose(r_g.pose.numpy(), r_d.pose.numpy(), atol=1e-5)
    for f in ("num_assoc", "iterations", "success"):
        assert torch.equal(getattr(r_g, f), getattr(r_d, f)), f
    r_j, r_jd = (jreg.register(kf, jnp.asarray(kf_poses),
                               jnp.asarray(kf_valid), src, jnp.asarray(guess),
                               cfg=c) for c in (cfg_g, cfg_d))
    assert r_g.success.item() and bool(r_j.success)
    d_dense = np.abs(r_d.pose[0].numpy() - np.asarray(r_jd.pose)).max()
    assert np.abs(r_g.pose[0].numpy() - np.asarray(r_j.pose)).max() \
        <= d_dense + 1e-5
    for f in ("num_assoc", "iterations"):
        assert getattr(r_g, f).item() == int(getattr(r_j, f)) \
            == int(getattr(r_jd, f)), f
    c_j, n_j = jreg.get_cost(kf, jnp.asarray(kf_poses), jnp.asarray(kf_valid),
                             src, jnp.asarray(guess), cfg_g)
    c_t, n_t = treg.get_cost(_lane(kf), torch.as_tensor(kf_poses)[None],
                             torch.as_tensor(kf_valid)[None], _lane(src),
                             torch.as_tensor(guess)[None],
                             both_cfgs(cfg_g)[1])
    assert n_t.item() == int(n_j)
    np.testing.assert_allclose(c_t.item(), float(c_j), rtol=1e-5)


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


def _jax_args(kf_cells, kf_poses, kf_valid, src, pose):
    return (kf_cells, jnp.asarray(kf_poses), jnp.asarray(kf_valid), src,
            jnp.asarray(pose))


def _port_args(kf_cells, kf_poses, kf_valid, src, pose):
    return (_lane(kf_cells), torch.as_tensor(kf_poses)[None],
            torch.as_tensor(kf_valid)[None], _lane(src),
            torch.as_tensor(np.asarray(pose, np.float32))[None])


@pytest.mark.parametrize("cost,method", [
    ("P2P", "pallas"), ("P2L", "dense"), ("P2D", "pallas"),
    ("P2P", "pallas_sparse")])
def test_get_cost_matches_jax(cost, method):
    cfg, kf_cells, kf_poses, src, guess = _problem(cost, method)
    kf_valid = np.array([True, False, True])
    _, cfg_t = both_cfgs(cfg)
    for pose in (guess, guess + np.float32([0.4, -0.3, 0.01])):
        c_j, n_j = jreg.get_cost(*_jax_args(kf_cells, kf_poses, kf_valid, src,
                                            pose), cfg)
        c_t, n_t = treg.get_cost(*_port_args(kf_cells, kf_poses, kf_valid,
                                             src, pose), cfg_t)
        assert int(n_j) > 100 and n_t[0].item() == int(n_j)
        np.testing.assert_allclose(c_t[0].item(), float(c_j), rtol=1e-5)


def _jax_offsets(cfg):
    odo = cfg.odometry
    k = odo.cov_sampling_samples_per_axis
    xy = jnp.linspace(-odo.cov_sampling_xy_range * 0.5,
                      odo.cov_sampling_xy_range * 0.5, k)
    th = jnp.linspace(-odo.cov_sampling_yaw_range * 0.5,
                      odo.cov_sampling_yaw_range * 0.5, k)
    gx, gy, gt = jnp.meshgrid(xy, xy, th, indexing="ij")
    return jnp.stack([gx.ravel(), gy.ravel(), gt.ravel()], -1)


def _exact_sampled_cov(costs, n_res, offs, cfg):
    """The reference's `sample_covariance` formula on given costs, with the
    least-squares fit solved exactly (numpy, float64, no singular-value
    cutoff). Returns (cov, convex)."""
    x, y, t = np.asarray(offs, np.float64).T
    A = np.stack([x * x, y * y, t * t, x * y, y * t, t * x, x, y, t,
                  np.ones_like(x)], -1)
    c = np.linalg.lstsq(A, np.asarray(costs, np.float64), rcond=None)[0]
    H = np.array([[2 * c[0], c[3], c[5]], [c[3], 2 * c[1], c[4]],
                  [c[5], c[4], 2 * c[2]]])
    convex = bool((np.linalg.eigvalsh(H) > 0).all())
    centre = int(np.argmin((np.asarray(offs) ** 2).sum(-1)))
    dof = max(float(n_res[centre]) - 3.0, 1.0)
    cov = 2.0 * np.linalg.inv(H + (not convex) * np.eye(3)) \
        * float(costs[centre]) / dof \
        * cfg.odometry.cov_sampling_covariance_scaler
    return cov, convex


@pytest.mark.parametrize("cost,method,k_active", [
    ("P2P", "pallas", 0), ("P2L", "dense", 2), ("P2D", "pallas", 0)])
def test_sample_covariance_matches_jax(cost, method, k_active):
    """The 27 costs (one association pass over 27 lanes) against the
    reference's `get_cost` at the same offsets, with and without the
    keyframe gate; the covariance and the convexity flag against the
    reference's formula on those costs. The port solves the fit exactly;
    the reference's float32 `jnp.linalg.lstsq` cuts singular values below
    27 float32 ulps of the largest, which at the default sampling ranges
    (condition ~5e5) drops the yaw curvature, so its fit is never convex
    and it keeps the Censi covariance (ROADMAP queue 3). That is pinned
    here too."""
    import jax
    cfg, kf_cells, kf_poses, src, guess = _problem(cost, method)
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, max_active_keyframes=k_active))
    _, cfg_t = both_cfgs(cfg)
    kf_valid = np.ones(3, bool)
    pose = np.array([2.5, 0.8, 0.06], np.float32)          # the optimum
    j_args = _jax_args(kf_cells, kf_poses, kf_valid, src, pose)
    t_args = _port_args(kf_cells, kf_poses, kf_valid, src, pose)
    offs = treg._sampling_offsets(cfg_t, torch.float32, "cpu")
    np.testing.assert_array_equal(offs.numpy(), np.asarray(_jax_offsets(cfg)))
    wk, wp, wv = jreg._active_window(*j_args[:3], j_args[4], cfg)
    c_j, n_j = jax.vmap(lambda o: jreg.get_cost(wk, wp, wv, src, j_args[4] + o,
                                                cfg))(jnp.asarray(offs.numpy()))
    tk, tp, tv = treg._active_window(*t_args[:3], t_args[4], cfg_t)
    c_t, n_t = treg._cost_at_offsets(tk, tp, tv, t_args[3], t_args[4], offs,
                                     cfg_t)
    np.testing.assert_array_equal(n_t[0].numpy(), np.asarray(n_j))
    np.testing.assert_allclose(c_t[0].numpy(), np.asarray(c_j), rtol=1e-5)
    cov_want, convex_want = _exact_sampled_cov(np.asarray(c_j),
                                               np.asarray(n_j), offs, cfg)
    cov_t, convex_t = treg.sample_covariance(*t_args, cfg_t)
    assert convex_want and convex_t[0].item()
    np.testing.assert_allclose(cov_t[0].numpy(), cov_want, rtol=0,
                               atol=1e-3 * np.abs(cov_want).max())
    assert np.linalg.eigvalsh(cov_t[0].numpy().astype(np.float64)).min() > 0
    _, convex_j = jreg.sample_covariance(*j_args, cfg)
    assert not bool(convex_j)


def test_sample_covariance_lanes_equal_single_calls():
    """Two lanes (other poses, another valid set) of one call equal the
    single-lane calls: the offsets of every lane share one pass."""
    cfg, kf_cells, kf_poses, src, guess = _problem("P2P", "pallas")
    _, cfg_t = both_cfgs(cfg)
    poses = np.stack([np.float32([2.5, 0.8, 0.06]), guess])
    valid = np.array([[1, 1, 1], [1, 0, 1]], bool)
    b = 2
    kfc = CellMap(*(torch.as_tensor(np.array(t))[None].expand(
        (b,) + t.shape).contiguous() for t in kf_cells))
    srcb = CellMap(*(torch.as_tensor(np.array(t))[None].expand(
        (b,) + t.shape).contiguous() for t in src))
    cov_b, convex_b = treg.sample_covariance(
        kfc, torch.as_tensor(kf_poses)[None].expand(b, -1, -1),
        torch.as_tensor(valid), srcb, torch.as_tensor(poses), cfg_t)
    for i in range(b):
        cov_1, convex_1 = treg.sample_covariance(
            *_port_args(kf_cells, kf_poses, valid[i], src, poses[i]), cfg_t)
        assert convex_b[i].item() == convex_1[0].item()
        np.testing.assert_allclose(cov_b[i].numpy(), cov_1[0].numpy(),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("method,rtol", [("pallas", 1e-5), ("dense", 1e-3)])
def test_cost_surface_matches_jax(method, rtol, monkeypatch):
    """The surface on a 5 x 5 grid. With the dense form's |s|^2 + |t|^2 -
    2 s.t distances, which XLA and torch round differently, a near-tie
    association can flip at a grid pose and move its cost by ~2e-4
    relative; the difference form of kernel A's twin gives 1e-5."""
    cfg, kf_cells, kf_poses, src, guess = _problem("P2L", method)
    _, cfg_t = both_cfgs(cfg)
    kf_valid = np.ones(3, bool)
    if method == "dense":          # several passes of bounded size
        monkeypatch.setattr(treg, "_DENSE_ELEMENTS", 3 * 512 * 512 * 7)
    s_j, ext_j = jreg.cost_surface(*_jax_args(kf_cells, kf_poses, kf_valid,
                                              src, guess), cfg, width=1.0,
                                   res=0.5)
    s_t, ext_t = treg.cost_surface(*_port_args(kf_cells, kf_poses, kf_valid,
                                               src, guess), cfg_t, width=1.0,
                                   res=0.5)
    assert ext_t == ext_j and s_t.shape == (1, 5, 5)
    np.testing.assert_allclose(s_t[0].numpy(), np.asarray(s_j), rtol=rtol)
    # the grid's centre is the cost at the pose itself
    c_t, _ = treg.get_cost(*_port_args(kf_cells, kf_poses, kf_valid, src,
                                       guess), cfg_t)
    assert s_t[0, 2, 2].item() == c_t[0].item()


def test_is_consistent_and_register_scans_service_match_jax():
    cfg, kf_cells, kf_poses, src, guess = _problem("P2P", "pallas")
    _, cfg_t = both_cfgs(cfg)
    rng = np.random.default_rng(4)
    pose = rng.normal(size=(64, 3)).astype(np.float32) * [1.0, 1.0, 0.1]
    ref_pose = pose + rng.normal(size=(64, 3)).astype(np.float32) \
        * [0.8, 0.8, 0.08]
    for dist, ang in ((1.0, 5.0), (0.5, 2.0)):
        want = np.asarray(jnp.stack([jreg.is_consistent(
            jnp.asarray(a), jnp.asarray(b), dist, ang)
            for a, b in zip(pose, ref_pose)]))
        got = treg.is_consistent(torch.as_tensor(pose),
                                 torch.as_tensor(ref_pose), dist, ang)
        assert want.any() and not want.all()
        np.testing.assert_array_equal(got.numpy(), want)
    # the service: the newest scan against the others, one good initial
    # pose and one far from the truth
    scans = _stack_keyframes([*[jnp_tree for jnp_tree in
                                (tuple(a[i] for a in kf_cells)
                                 for i in range(3))], tuple(src)])
    for init in (guess, guess + np.float32([2.5, 0.0, 0.0])):
        poses = np.concatenate([kf_poses, init[None]]).astype(np.float32)
        r_j, ok_j = jreg.register_scans_service(
            type(kf_cells)(*scans), jnp.asarray(poses), cfg)
        r_t, ok_t = treg.register_scans_service(
            _lane(type(kf_cells)(*scans)), torch.as_tensor(poses)[None],
            cfg_t)
        assert ok_t[0].item() == bool(ok_j)
        np.testing.assert_allclose(r_t.pose[0].numpy(), np.asarray(r_j.pose),
                                   atol=1e-5)
        assert r_t.num_assoc[0].item() == int(r_j.num_assoc)


def test_register_time_continuous_and_compensate_cells_match_jax():
    from cfear_radarodometry_code_public_tpu.ops import features as jf
    from cfear_radarodometry_code_public_tpu_torch.ops import features as tf
    cfg, kf_cells, kf_poses, src, guess = _problem("P2P", "pallas")
    _, cfg_t = both_cfgs(cfg)
    tvel = np.float32([1.2, -0.4, 0.03])
    for ccw in (False, True):
        c_j = jf.compensate_cells(src, jnp.asarray(tvel), ccw)
        c_t = tf.compensate_cells(_lane(src), torch.as_tensor(tvel)[None], ccw)
        for name in ("mean", "normal", "cov"):
            want = np.asarray(getattr(c_j, name))
            np.testing.assert_allclose(getattr(c_t, name)[0].numpy(), want,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)
        t_j = jf.transform_cells(src, jnp.asarray(guess))
        t_t = tf.transform_cells(_lane(src), torch.as_tensor(guess)[None])
        for name in ("mean", "normal", "cov"):
            want = np.asarray(getattr(t_j, name))
            np.testing.assert_allclose(getattr(t_t, name)[0].numpy(), want,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)
    kf_valid = np.ones(3, bool)
    r_j = jreg.register_time_continuous(
        *_jax_args(kf_cells, kf_poses, kf_valid, src, guess),
        jnp.asarray(tvel), False, cfg=cfg)
    r_t = treg.register_time_continuous(
        *_port_args(kf_cells, kf_poses, kf_valid, src, guess),
        torch.as_tensor(tvel)[None], False, cfg=cfg_t)
    assert bool(r_j.success) and r_t.success[0].item()
    np.testing.assert_allclose(r_t.pose[0].numpy(), np.asarray(r_j.pose),
                               atol=1e-5)
    assert r_t.num_assoc[0].item() == int(r_j.num_assoc)


@pytest.mark.parametrize("cost,cov_guess", [
    ("P2P", None), ("P2L", None), ("P2D", "diag")])
def test_soft_constraint_register_matches_jax(cost, cov_guess):
    """`soft_constraint`: the einsum LM with the guess prior, against the
    reference's `_lm_solve`, with the identity prior covariance and a
    diagonal one."""
    cfg, kf_cells, kf_poses, src, guess = _problem(cost, "pallas")
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, soft_constraint=True))
    _, cfg_t = both_cfgs(cfg)
    kf_valid = np.ones(3, bool)
    cg = None if cov_guess is None else np.diag(
        np.float32([0.04, 0.09, 0.001]))
    r_j = jreg.register(*_jax_args(kf_cells, kf_poses, kf_valid, src, guess),
                        None if cg is None else jnp.asarray(cg), cfg=cfg)
    r_t = treg.register(*_port_args(kf_cells, kf_poses, kf_valid, src, guess),
                        None if cg is None else torch.as_tensor(cg)[None],
                        cfg=cfg_t)
    assert bool(r_j.success)
    np.testing.assert_allclose(r_t.pose[0].numpy(), np.asarray(r_j.pose),
                               atol=1e-5)
    for f in ("num_assoc", "iterations", "success"):
        assert getattr(r_t, f)[0].item() == np.asarray(getattr(r_j, f)).item(), f
    np.testing.assert_allclose(r_t.score[0].item(), float(r_j.score),
                               rtol=1e-4)
    np.testing.assert_allclose(r_t.cov[0].numpy(), np.asarray(r_j.cov),
                               rtol=1e-3, atol=1e-9)
    # the prior pulls towards the guess: not the unconstrained optimum
    r_free = treg.register(*_port_args(kf_cells, kf_poses, kf_valid, src,
                                       guess), cfg=both_cfgs(_problem(
                                           cost, "pallas")[0])[1])
    assert not torch.equal(r_free.pose, r_t.pose)


@pytest.mark.parametrize("cost,pairs", [("P2L", None), ("P2P", 1)])
def test_refine_many_to_many_matches_jax(cost, pairs):
    """`tests/test_registration.py:238`'s three scans at perturbed poses:
    the joint refinement's poses within 1e-5 of the reference's (4e-7
    seen), the first pose fixed, each closer to the truth than its start.
    `pairs`=1 pairs each scan with its nearest other only."""
    rng = np.random.default_rng(11)
    cfg = _cfg(cost, "Huber", "Combined")
    xy, intens = _world_cloud(rng)
    true = np.array([[0.0, 0.0, 0.0], [2.0, 0.5, 0.05], [4.0, 1.0, 0.10]])
    cells = _stack_keyframes([_cells_from_world(xy, intens, p, cfg)
                              for p in true])
    noisy = (true + np.array([[0, 0, 0], [0.3, -0.2, 0.02],
                              [-0.25, 0.3, -0.03]])).astype(np.float32)
    want = np.asarray(jreg.refine_many_to_many(
        cells, jnp.asarray(noisy), jnp.ones(3, bool), cfg,
        pairs_per_scan=pairs))
    _, cfg_t = both_cfgs(cfg)
    got = treg.refine_many_to_many(
        to_torch(cells, CellMap), torch.as_tensor(noisy),
        torch.ones(3, dtype=torch.bool), cfg_t, pairs_per_scan=pairs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[0], noisy[0])
    assert (np.linalg.norm(got[1:, :2] - true[1:, :2], axis=1)
            < np.linalg.norm(noisy[1:, :2] - true[1:, :2], axis=1)).all()
