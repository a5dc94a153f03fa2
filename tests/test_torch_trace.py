"""The port's profiler spans and counters (`utils/trace.py`).

Without a profiler every span is the one shared no-op context and no
counter moves. Under `torch.profiler` (CPU) a 2-lane fleet run on the small
synthetic sensor opens each span as often as the code implies: per chunk
one `sync.bootstrap`, one `fleet.upload` and one `fleet.readback` (and one
more of the last two for the bootstrap frame), per frame one of each
`features.*` stage, per step as many `associate` ranges as the lanes'
largest outer iteration count and one `sync.register` fewer where that
count reached `max_itr_association` (the loop then ends without a check).
The rows counted off the grid (`features.points` less
`features.points_in_grid`) equal a direct numpy count, on both feature
backends, and the frame outputs are bit-identical with the profiler on and
off (exact: the spans and counters launch nothing that feeds them)."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cfear_radarodometry_code_public_tpu_torch.config import preset
from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
from cfear_radarodometry_code_public_tpu_torch.ops import features
from cfear_radarodometry_code_public_tpu_torch.ops.filtering import PointCloud
from cfear_radarodometry_code_public_tpu_torch.parallel import mesh
from cfear_radarodometry_code_public_tpu_torch.utils import trace

FRAMES, CHUNK, LANES = 9, 4, 2


def _cfg():
    """The fleet tests' small sensor (`tests/test_torch_parallel.py`)."""
    cfg = preset("CFEAR-3", dataset="synthetic")
    radar = dataclasses.replace(cfg.radar, n_azimuths=128, n_bins=256,
                                range_res=0.6, max_distance=100.0)
    return cfg.replace(
        radar=radar, feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8))


@pytest.fixture(scope="module")
def fleet():
    cfg = _cfg()
    images = np.stack([synthetic.make_sequence(seed=40 + s, n_frames=FRAMES,
                                               cfg=cfg)[0]
                       for s in range(LANES)])
    return cfg, images


def _run(cfg, images):
    r = mesh.MultiSequenceRunner(cfg, LANES, chunk=CHUNK, device="cpu")
    r.process(images)
    return r.frame_outputs()


def _range_counts(prof):
    return {e.key: e.count for e in prof.key_averages()}


def test_without_a_profiler_spans_are_the_shared_noop(fleet):
    assert trace.span("register") is trace.span("fleet.upload")
    assert not isinstance(trace.span("x"), torch.profiler.record_function)
    trace.reset_counters()
    trace.count("features.points", 5)
    trace.count("features.points_in_grid", torch.tensor(3.0))
    _run(*fleet)
    assert trace.counters() == {}


def test_a_fleet_run_opens_the_spans_the_code_implies(fleet):
    cfg, images = fleet
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(cfg, images)
    n = _range_counts(prof)
    chunks = -(-(FRAMES - 1) // CHUNK)
    assert n["sync.bootstrap"] == 1
    assert n["fleet.upload"] == n["fleet.readback"] == chunks + 1
    for name in ("Filtering", "build_normals", "features.voxels",
                 "features.moments", "features.cells"):
        assert n[name] == FRAMES, name
    assert n["register"] == FRAMES - 1
    itr = out.reg_iterations[:, 1:].max(0)
    top = cfg.registration.max_itr_association
    assert n["associate"] == n["lm_solve"] == itr.sum()
    assert n["sync.register"] == np.minimum(itr, top - 1).sum()
    assert (itr == top).any() and (itr < top).any()
    assert "sync.health_check" not in n      # the check is off in CFEAR-3
    c = trace.counters()
    assert c["features.points"] == FRAMES * LANES * \
        cfg.radar.n_azimuths * cfg.filter.k_strongest
    assert 0 < c["features.points_in_grid"] < c["features.points"]
    trace.reset_counters()
    assert trace.counters() == {}


def _points(cfg, n, seed):
    """Points of which some are invalid and some valid but off the voxel
    grid: (PointCloud, numpy off-grid mask)."""
    rng = np.random.default_rng(seed)
    leaf, dim, _ = features._grid_geometry(cfg)
    edge = (dim // 2) * leaf
    xy = rng.uniform(-1.4 * edge, 1.4 * edge, (2, n, 2)).astype(np.float32)
    valid = rng.random((2, n)) < 0.8
    off = ~valid | (np.floor(xy / np.float32(leaf)) + dim // 2 < 0).any(-1) \
        | (np.floor(xy / np.float32(leaf)) + dim // 2 >= dim).any(-1)
    pts = PointCloud(xy=torch.from_numpy(xy),
                     intensity=torch.from_numpy(
                         rng.uniform(60, 120, (2, n)).astype(np.float32)),
                     valid=torch.from_numpy(valid),
                     peak=torch.from_numpy(valid.copy()))
    return pts, off


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_the_off_grid_rows_equal_a_numpy_count(backend):
    cfg = _cfg()
    cfg = cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                  backend=backend))
    pts, off = _points(cfg, 1024, 7)
    assert 0 < (off & pts.valid.numpy()).sum() and (~pts.valid.numpy()).any()
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        features.compute_cells_batched(pts, cfg)
        features.compute_cells_batched(pts, cfg)
    c = trace.counters()
    trace.reset_counters()
    assert c == {"features.points": 2 * off.size,
                 "features.points_in_grid": 2 * int((~off).sum())}
    assert c["features.points"] - c["features.points_in_grid"] == \
        2 * int(off.sum())
    n = _range_counts(prof)
    assert n["features.voxels"] == n["features.moments"] == \
        n["features.cells"] == 2


def test_outputs_are_bit_identical_with_the_profiler_on_and_off(fleet):
    off = _run(*fleet)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _run(*fleet)
    trace.reset_counters()
    for name, a, b in zip(off._fields, off, on):
        np.testing.assert_array_equal(a, b, err_msg=name)
