"""Port point building and cell extraction against the JAX reference.

`compute_cells_batched` (B=2) gets identical numpy points on both sides:
the valid mask, the cell count and the (Morton) order are compared exactly,
floats within 1e-5 relative to the largest value (f32 sums in another
order: `index_add_` against `segment_sum`). The pallas backend (kernel G's
plain twin against the reference's moment kernel in interpret mode) is
held as the reference holds it against its scatter backend: nsamples and
the cell set exact, means and covariances within 1e-4."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs, jax, jnp, ref, slice_cfg

from cfear_radarodometry_code_public_tpu.ops import features as jf
from cfear_radarodometry_code_public_tpu.ops import filtering as jfl
from cfear_radarodometry_code_public_tpu.ops import pallas_features as jpf
from cfear_radarodometry_code_public_tpu_torch.utils import native_io
from cfear_radarodometry_code_public_tpu_torch.ops import cuda_features as tcf
from cfear_radarodometry_code_public_tpu_torch.ops import features as tf
from cfear_radarodometry_code_public_tpu_torch.ops import filtering as tfl


def _points(cfg, seed=0, b=2, n=2500):
    """Wall-like clouds with speckle, as numpy PointCloud leaves."""
    rng = np.random.default_rng(seed)
    xy = []
    for _ in range(b):
        walls = []
        for _ in range(14):
            p0 = rng.uniform(-60, 60, 2)
            ang = rng.uniform(0, 2 * np.pi)
            t = rng.uniform(0, 40, n // 16)
            walls.append(p0 + np.stack([np.cos(ang) * t, np.sin(ang) * t], -1)
                         + rng.normal(0, 0.15, (len(t), 2)))
        cloud = np.concatenate(walls)
        cloud = np.concatenate([cloud, rng.uniform(-90, 90, (n - len(cloud), 2))])
        xy.append(cloud)
    xy = np.stack(xy).astype(np.float32)
    intensity = rng.uniform(40, 220, (b, n)).astype(np.float32)
    valid = rng.random((b, n)) < 0.92
    peak = valid & (rng.random((b, n)) < 0.5)
    return xy, intensity, valid, peak


def _cells_both(cfg_j, cfg_t, leaves):
    jc = jf.compute_cells_batched(
        jfl.PointCloud(*(jnp.asarray(a) for a in leaves)), cfg_j)
    tc = tf.compute_cells_batched(
        tfl.PointCloud(*(torch.as_tensor(a) for a in leaves)), cfg_t)
    return jc, tc


@pytest.mark.parametrize("spatial_sort,budget", [(False, 0), (True, 0),
                                                 (True, 1800)])
def test_compute_cells_batched_matches(spatial_sort, budget):
    cfg_j, cfg_t = slice_cfg(spatial_sort=spatial_sort)
    cfg_j = cfg_j.replace(feature=dataclasses.replace(
        cfg_j.feature, point_budget=budget, max_cells=256))
    cfg_t = both_cfgs(cfg_j)[1]
    jc, tc = _cells_both(cfg_j, cfg_t, _points(cfg_j))
    valid = np.asarray(jc.valid)
    assert valid.sum(1).min() > 50
    np.testing.assert_array_equal(tc.valid.numpy(), valid)
    np.testing.assert_array_equal(tc.n.numpy(), valid.sum(1))
    np.testing.assert_array_equal(tc.nsamples.numpy(), np.asarray(jc.nsamples))
    for name in ("mean", "normal", "cov", "planarity"):
        want = np.asarray(getattr(jc, name))
        np.testing.assert_allclose(getattr(tc, name).numpy(), want,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_compute_cells_overflow_keeps_most_supported():
    """More valid cells than max_cells: the stable nsamples ranking picks
    the same cells in the same order."""
    cfg_j, _ = slice_cfg()
    cfg_j = cfg_j.replace(feature=dataclasses.replace(cfg_j.feature,
                                                      max_cells=64))
    cfg_t = both_cfgs(cfg_j)[1]
    jc, tc = _cells_both(cfg_j, cfg_t, _points(cfg_j, seed=4))
    assert np.asarray(jc.valid).all()
    np.testing.assert_array_equal(tc.nsamples.numpy(), np.asarray(jc.nsamples))
    np.testing.assert_allclose(tc.mean.numpy(), np.asarray(jc.mean), atol=1e-4)


def test_compute_cells_single_scan_and_helpers():
    cfg_j, cfg_t = slice_cfg()
    leaves = [a[0] for a in _points(cfg_j, seed=2)]
    jc = jf.compute_cells(jfl.PointCloud(*(jnp.asarray(a) for a in leaves)),
                          cfg_j)
    tc = tf.compute_cells(tfl.PointCloud(*(torch.as_tensor(a) for a in leaves)),
                          cfg_t)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    assert tf._grid_geometry(cfg_t) == jf._grid_geometry(cfg_j)
    ix = np.random.default_rng(0).integers(0, 1 << 15, (2, 50)).astype(np.int32)
    np.testing.assert_array_equal(
        tf._morton2(torch.as_tensor(ix[0]), torch.as_tensor(ix[1])).numpy(),
        np.asarray(jf._morton2(jnp.asarray(ix[0]), jnp.asarray(ix[1]))))


def test_budget_points_matches():
    cfg_j, _ = slice_cfg()
    xy, inten, valid, peak = _points(cfg_j, seed=3)
    inten = np.round(inten / 8) * 8          # many equal intensities: ties
    leaves = (xy, inten, valid, peak)
    jb = jf.budget_points(jfl.PointCloud(*(jnp.asarray(a) for a in leaves)), 700)
    tb = tf.budget_points(tfl.PointCloud(*(torch.as_tensor(a) for a in leaves)),
                          700)
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("kind", ["compact", "candidates"])
def test_points_from_host_rows_match(kind):
    cfg_j, cfg_t = slice_cfg()
    from cfear_radarodometry_code_public_tpu.datasets import synthetic
    images, _ = synthetic.make_sequence(seed=3, n_frames=2, cfg=cfg_j)
    f = cfg_j.filter
    if kind == "compact":
        min_bin = int(math.ceil(cfg_j.radar.min_distance
                                / cfg_j.radar.range_res))
        rows = native_io.filter_frames_host_compact(
            images, f.k_strongest, f.z_min, f.nms_window,
            cfg_j.feature.point_budget, min_bin)
        jp = jax.vmap(lambda c: jfl.points_from_compact(c, cfg_j))(
            jfl.CompactCandidates(*map(jnp.asarray, rows)))
        tp = tfl.points_from_compact(
            tfl.CompactCandidates(*map(torch.as_tensor, rows)), cfg_t)
    else:
        rows = native_io.filter_frames_host(images, f.k_strongest, f.z_min,
                                            f.nms_window)
        jp = jax.vmap(lambda c: jfl.points_from_candidates(c, cfg_j))(
            jfl.Candidates(*map(jnp.asarray, rows)))
        tp = tfl.points_from_candidates(
            tfl.Candidates(*map(torch.as_tensor, rows)), cfg_t)
    assert np.asarray(jp.valid).sum() > 1000
    for name in ("intensity", "valid", "peak"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    # cos/sin of the azimuth differ by an ulp between XLA and torch
    np.testing.assert_allclose(tp.xy.numpy(), np.asarray(jp.xy), atol=4e-5)


@pytest.mark.parametrize("field,value", [("use_raw_pointcloud", True)])
def test_unported_feature_options_raise(field, value):
    cfg_j, _ = slice_cfg()
    cfg_t = both_cfgs(cfg_j.replace(feature=dataclasses.replace(
        cfg_j.feature, **{field: value})))[1]
    leaves = _points(cfg_j)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.compute_cells_batched(
            tfl.PointCloud(*(torch.as_tensor(a) for a in leaves)), cfg_t)


def _pallas_cfgs(**feature):
    cfg_j, _ = slice_cfg(spatial_sort=True, backend="pallas", **feature)
    return both_cfgs(cfg_j)


def _torch_points(leaves):
    return tfl.PointCloud(*(torch.as_tensor(a) for a in leaves))


@pytest.mark.parametrize("pre_cells", [0, 256])
def test_compute_cells_pallas_backend_matches_jax(pre_cells):
    """pre_cells=0 is the default budget (4608, every occupied voxel kept);
    256 drops the voxels beyond it in vid order on both sides."""
    cfg_j, cfg_t = _pallas_cfgs(pre_cells=pre_cells)
    leaves = _points(cfg_j, seed=5, n=2560)     # budgeted to 2048 points
    jc, tc = _cells_both(cfg_j, cfg_t, leaves)
    valid = np.asarray(jc.valid)
    assert valid.sum(1).min() > (20 if pre_cells else 150)
    np.testing.assert_array_equal(tc.valid.numpy(), valid)
    np.testing.assert_array_equal(tc.nsamples.numpy(), np.asarray(jc.nsamples))
    for name in ("mean", "cov"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(np.abs(tc.normal.numpy()),
                               np.abs(np.asarray(jc.normal)), atol=1e-3)
    inputs = tf._moment_inputs(tf.budget_points(_torch_points(leaves), 2048),
                               cfg_t)
    occupied = (tcf.moment_accumulate(*inputs)[:, 0] > 0).sum(-1)
    if pre_cells:
        assert (occupied == pre_cells).all()       # the budget is full
    else:
        assert (occupied < inputs[-1]).all()       # nothing was dropped


@pytest.mark.parametrize("source", ["pipeline", "random"])
def test_moment_accumulate_plain_matches_jax(source):
    """Kernel G's twin against the reference kernel in interpret mode on
    the same pack: counts equal, moments within 1e-4 of each row's scale.
    "pipeline" packs real points with the x-slab bounds the feature stage
    computes; "random" packs arbitrary rows with bounds that skip nothing."""
    cfg_j, cfg_t = _pallas_cfgs(pre_cells=1024)
    if source == "pipeline":
        leaves = _points(cfg_j, seed=6, n=2048)
        pack, ct_lo, ct_hi, pt_lo, pt_hi, offsets_m, n_off, c_pre = \
            tf._moment_inputs(_torch_points(leaves), cfg_t)
    else:
        rng = np.random.default_rng(6)
        b, n, n_off, c_pre = 2, 1024, 9, 1024
        mem = rng.random((b, n_off, n)) < 0.3
        trank = np.where(mem, rng.integers(0, c_pre, (b, n_off, n)), c_pre)
        pack = np.concatenate(
            [rng.uniform(-1.5, 1.5, (b, 2, n)), rng.uniform(0, 160, (b, 1, n)),
             rng.uniform(-100, 100, (b, 2, n)), mem, trank,
             np.zeros((b, 1, n))], 1).astype(np.float32)
        pack = torch.as_tensor(pack)
        inf = torch.tensor(float("inf"))
        ct_lo, ct_hi = -inf.expand(b, c_pre // 128), inf.expand(b, c_pre // 128)
        pt_lo, pt_hi = -inf.expand(b, n // 512), inf.expand(b, n // 512)
        ct_lo, ct_hi, pt_lo, pt_hi = (t.contiguous() for t in
                                      (ct_lo, ct_hi, pt_lo, pt_hi))
        offsets_m = tuple((dx * 3.0, dy * 3.0) for dx in (-1, 0, 1)
                          for dy in (-1, 0, 1))
    got = tcf.moment_accumulate(pack, ct_lo, ct_hi, pt_lo, pt_hi, offsets_m,
                                n_off, c_pre).numpy()
    want = np.asarray(jpf.moment_accumulate(
        jnp.asarray(pack.numpy()), jnp.asarray(ct_lo.numpy()),
        jnp.asarray(ct_hi.numpy()), jnp.asarray(pt_lo.numpy()),
        jnp.asarray(pt_hi.numpy()), offsets_m=offsets_m, n_off=n_off,
        c_pre=c_pre, interpret=True))
    assert got.shape == want.shape == (pack.shape[0], tcf.N_MOMENTS, c_pre)
    assert (want[:, 0] > 0).sum() > 200
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_array_equal(got[:, 9:], 0.0)
    for r in range(1, 9):
        np.testing.assert_allclose(got[:, r], want[:, r],
                                   atol=1e-4 * np.abs(want[:, r]).max(),
                                   err_msg=f"moment row {r}")


def test_auto_backend_is_the_scatter_form():
    cfg_j, _ = slice_cfg()
    leaves = _points(cfg_j, seed=7)
    cells = [tf.compute_cells_batched(_torch_points(leaves), both_cfgs(
        cfg_j.replace(feature=dataclasses.replace(cfg_j.feature,
                                                  backend=be)))[1])
        for be in ("auto", "xla")]
    for a, b in zip(*cells):
        assert torch.equal(a, b)


def test_pallas_backend_needs_tiling_point_count():
    cfg_j, _ = _pallas_cfgs()
    cfg_t = both_cfgs(cfg_j.replace(feature=dataclasses.replace(
        cfg_j.feature, point_budget=0)))[1]
    with pytest.raises(ValueError, match="multiple of 512"):
        tf.compute_cells_batched(_torch_points(_points(cfg_j, n=2500)), cfg_t)


def test_preset_is_the_reference_config():
    """The port re-exports the reference's config module (loaded by path)."""
    import cfear_radarodometry_code_public_tpu_torch as port
    assert port.preset("CFEAR-3").to_dict() == ref.preset("CFEAR-3").to_dict()
