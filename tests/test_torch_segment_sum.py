"""The port's segment sum (`features.segment_sum`, `cuda_segment_sum`).

On the CPU: `jax.ops.segment_sum`'s drop rule (ids outside [0, n) are
summed nowhere), row order within a segment, the edge cases, and the feature
stage's two calls bit for bit against the form they replace (an overflow
segment at B*ncells, cut away). On a CUDA card (marked `cuda`, skipped
without one): the kernel bit for bit against the twin, deterministic
`index_add_`, at the benchmark cells' shapes and the other callers'. This
file imports neither JAX nor the JAX package.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from cfear_radarodometry_code_public_tpu_torch import config
from cfear_radarodometry_code_public_tpu_torch.ops import (
    cuda_segment_sum, features, filtering)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

sys.path.remove(REPO)


def _row_order_sum(data, ids, n):
    """Each segment's rows added one by one from 0 in row order, float32."""
    data = np.asarray(data, np.float32)
    data = data.reshape(len(ids), int(np.prod(data.shape[1:])))
    out = np.zeros((n, data.shape[1]), np.float32)
    for r, s in enumerate(np.asarray(ids)):
        if 0 <= s < n:
            out[s] = out[s] + data[r]
    return out


def _old_form(data, ids, n):
    """The feature calls' former route: deterministic `index_add_` into
    n + 1 segments, the last the overflow of every off-grid row, cut away
    (ids already at most n)."""
    out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out.index_add_(0, ids, data)
    finally:
        torch.use_deterministic_algorithms(was)
    return out[:n]


@pytest.mark.parametrize("tail", [(), (3,), (3, 3)])
def test_drops_ids_outside_the_segments(tail):
    rng = np.random.default_rng(0)
    n, k = 7, 200
    ids = rng.integers(-4, n + 4, k)
    data = rng.standard_normal((k,) + tail).astype(np.float32)
    got = features.segment_sum(torch.as_tensor(data), torch.as_tensor(ids), n)
    assert got.shape == (n,) + tail
    want = _row_order_sum(data, ids, n)
    np.testing.assert_array_equal(got.numpy().reshape(n, -1), want)
    # the rows in range give the same sums with or without the others
    keep = (ids >= 0) & (ids < n)
    alone = features.segment_sum(torch.as_tensor(data[keep]),
                                 torch.as_tensor(ids[keep]), n)
    assert torch.equal(got, alone)


def test_sums_in_row_order():
    """Addition order shows in float32: 1e8 + 1 - 1e8 is 0 in row order."""
    data = torch.tensor([1e8, 1.0, -1e8, 1.0, 5.0], dtype=torch.float32)
    ids = torch.tensor([0, 0, 0, 1, 9])
    got = features.segment_sum(data, ids, 2)
    assert got.tolist() == [0.0, 1.0]


@pytest.mark.parametrize("case", ["all dropped", "one segment", "empty",
                                  "no rows", "no segments"])
def test_edge_cases(case):
    rng = np.random.default_rng(1)
    n, k = 6, 500
    ids = rng.integers(0, n, k)
    if case == "all dropped":
        ids = np.where(rng.random(k) < 0.5, n, -1)
    elif case == "one segment":
        ids[:] = 4
    elif case == "empty":
        ids = rng.choice([0, 5], k)
    elif case == "no rows":
        k, ids = 0, ids[:0]
    elif case == "no segments":
        n = 0
    data = rng.standard_normal((k, 3)).astype(np.float32)
    got = features.segment_sum(torch.as_tensor(data), torch.as_tensor(ids), n)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _row_order_sum(data, ids, n))
    if case == "empty":
        assert (got[1:5] == 0).all() and (got[[0, 5]] != 0).all()


def test_pose_graph_block_rows():
    """`posegraph._blocks`' shape: (E, 9) rows of J^T J into N nodes, ids
    in range, float64 as well (deterministic `index_add_` on any device)."""
    data, ids, n = chip_smoke.segment_sum_inputs(torch.device("cpu"), "blocks")
    got = features.segment_sum(data, ids, n)
    np.testing.assert_array_equal(got.numpy(),
                                  _row_order_sum(data.numpy(), ids.numpy(), n))
    got64 = features.segment_sum(data.double(), ids, n)
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got64.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_takes_the_twin_on_the_cpu_and_checks_its_inputs():
    data, ids, n = chip_smoke.segment_sum_inputs(torch.device("cpu"), "long")
    cuda_segment_sum.reset_launches()
    got = cuda_segment_sum.segment_sum(data, ids, n)
    assert torch.equal(got, cuda_segment_sum.segment_sum_plain(data, ids, n))
    assert cuda_segment_sum.launches["segment_sum"] == 0
    with pytest.raises(TypeError):
        cuda_segment_sum.segment_sum(data, ids.int(), n)
    with pytest.raises(ValueError):
        cuda_segment_sum.segment_sum(data, ids[1:], n)
    with pytest.raises(ValueError):
        cuda_segment_sum.segment_sum(data, ids, -1)
    was = torch.are_deterministic_algorithms_enabled()
    cuda_segment_sum.segment_sum_plain(data, ids, n)
    assert torch.are_deterministic_algorithms_enabled() == was


def _cell_points(b=3, n=2000, seed=2):
    """Clouds with walls, speckle, invalid points and points past the
    grid's edge (off the grid)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-60, 60, (b, n, 2))
    xy[:, : n // 2] = (rng.uniform(-30, 30, (b, 1, 2))
                       + rng.normal(0, 2.0, (b, n // 2, 2)))
    xy[:, -n // 10:] *= 50.0
    valid = rng.random((b, n)) < 0.9
    intensity = rng.uniform(40, 220, (b, n))
    return filtering.PointCloud(
        xy=torch.as_tensor(xy, dtype=torch.float32),
        intensity=torch.as_tensor(intensity, dtype=torch.float32),
        valid=torch.as_tensor(valid), peak=torch.as_tensor(valid))


def _cfg(**feature):
    cfg = config.preset("CFEAR-3", dataset="oxford")
    return cfg.replace(
        radar=dataclasses.replace(cfg.radar, max_distance=120.0),
        feature=dataclasses.replace(cfg.feature, **feature))


@pytest.mark.parametrize("c", [3, 63])
def test_feature_calls_bit_equal_to_the_overflow_form(c):
    """The stage-1 and stage-2 calls' ids (B=3, about a fifth of the points
    off the grid or invalid): dropping their rows gives the bits the former
    overflow segment did, for 3 and 63 columns."""
    cfg = _cfg()
    pts = _cell_points()
    leaf, dim, _ = features._grid_geometry(cfg)
    _, in_grid, _, vid_flat, _, _ = features._voxel_centroids(
        pts.xy, pts.valid, leaf, dim)
    b, ncells = pts.xy.shape[0], dim * dim
    off = float((~in_grid).float().mean())
    assert 0.1 < off < 0.4
    assert int(vid_flat.max()) == b * ncells
    data = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (vid_flat.numel(), c)).astype(np.float32))
    got = features.segment_sum(data, vid_flat, b * ncells)
    assert torch.equal(got, _old_form(data, vid_flat, b * ncells))


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_cells_bit_equal_to_the_overflow_form(monkeypatch, backend):
    """`compute_cells_batched` (both backends share stage 1; "auto" also
    runs stage 2's 63-column call) gives the same cells, bit for bit, when
    its segment sums take the former overflow form instead."""
    cfg = _cfg(backend=backend, max_cells=512)
    pts = _cell_points(n=2048)
    new = features.compute_cells_batched(pts, cfg)
    assert int(new.n.min()) > 20
    monkeypatch.setattr(features, "segment_sum", _old_form)
    old = features.compute_cells_batched(pts, cfg)
    for a, b_ in zip(new, old):
        assert torch.equal(a, b_)


# ----------------------------------------------------------- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*chip_smoke.SEGMENT_SUM_SHAPES,
                                  *chip_smoke.SEGMENT_OTHER_SHAPES])
def test_kernel_bit_equal_to_index_add(dev, name):
    """The kernel at the cells' shapes (B=32, N=16,000, 430,592 segments, 3
    and 63 columns, 28% of the rows dropped), one segment of 20,000 rows,
    the loop closer's ring histogram and the pose graph's blocks: bit-equal
    to deterministic `index_add_` into n + 1 rows cut to n on the CPU and,
    for rows of more than one column, on the card; two launches
    bit-identical, two launches a call."""
    data, ids, n = chip_smoke.segment_sum_inputs(dev, name)
    cuda_segment_sum.reset_launches()
    k1 = features.segment_sum(data, ids, n)
    k2 = features.segment_sum(data, ids, n)
    torch.cuda.synchronize()
    assert cuda_segment_sum.launches["segment_sum"] == 4
    assert torch.equal(k1, k2)
    assert torch.equal(k1.cpu(), cuda_segment_sum.segment_sum_plain(
        data.cpu(), ids.cpu(), n))
    if data.dim() > 1:
        assert torch.equal(k1, cuda_segment_sum.segment_sum_plain(data, ids,
                                                                  n))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all dropped", "no rows", "negative ids",
                                  "wide rows"])
def test_kernel_edge_cases(dev, case):
    rng = np.random.default_rng(4)
    n, k, c = 1000, 3000, 5
    ids = rng.integers(0, n, k)
    if case == "all dropped":
        ids[:] = n
    elif case == "no rows":
        k, ids = 0, ids[:0]
    elif case == "negative ids":
        ids[::3] = -1 - ids[::3]
    elif case == "wide rows":
        c = 130
    data = torch.as_tensor(rng.standard_normal((k, c)).astype(np.float32))
    ids = torch.as_tensor(ids)
    got = features.segment_sum(data.to(dev), ids.to(dev), n)
    assert torch.equal(got.cpu(), cuda_segment_sum.segment_sum_plain(
        data, ids, n))


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(dev):
    data = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    ids = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        cuda_segment_sum.segment_sum(data, ids, 2)
    # float64 on the card takes deterministic index_add_ in features
    assert features.segment_sum(data, ids, 2).dtype == torch.float64
