"""The port's CUDA kernels on a card, against their plain PyTorch twins.

Needs a CUDA card and nvcc; every test skips without a card. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc as ca
from cfear_radarodometry_code_public_tpu_torch.ops import (
    cuda_features, cuda_lm, features, filtering)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

sys.path.remove(REPO)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, b=8, s=4, m=1024, seed=0):
    """Slice-shaped inputs: targets near the sources, an empty keyframe,
    a tie between two identical targets in different 512-row tiles."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(b, m, 2)) * 50).astype(np.float32)
    src = np.take_along_axis(src, np.argsort(src[..., :1], 1, kind="stable"), 1)
    tar = src[:, None] + rng.normal(size=(b, s, m, 2)).astype(np.float32)
    valid = rng.random((b, s, m)) < 0.9
    valid[:, s - 1] = False
    if m > 700:
        tar[0, 0, 700] = tar[0, 0, 300]
        valid[0, 0, [300, 700]] = True
        src[0, 9] = tar[0, 0, 300]
    return [torch.as_tensor(a).to(dev) for a in (src, tar, valid)]


def test_kernel_a_bit_equal_to_plain(dev):
    src, tar, valid = _inputs(dev)
    ca.reset_launches()
    nn_k, d2_k = ca.nn_min(src, tar, valid)
    nn_p, d2_p = ca.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)
    assert nn_k[0, 0, 9].item() == 300
    assert torch.isinf(d2_k[:, -1]).all() and (nn_k[:, -1] == 0).all()
    assert {k: v for k, v in ca.launches.items() if v} == {"nn_min": 1}


@pytest.mark.parametrize("radius", [2.0, 4.0])
def test_kernel_c_bit_equal_to_plain(dev, radius):
    src, tar, valid = _inputs(dev)
    sb = ca.tile_bounds(src, torch.ones_like(valid[:, 0]), ca.TS_SPARSE)
    tb = ca.tile_bounds(tar, valid, ca.TT_SPARSE)
    r = torch.full((src.shape[0],), radius, device=dev)
    ca.reset_launches()
    nn_k, d2_k = ca.nn_min_sparse(src, sb, tar, tb, valid, r)
    nn_p, d2_p = ca.nn_min_sparse_plain(src, sb, tar, tb, valid, r)
    nn_a, d2_a = ca.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)
    within = d2_a <= radius * radius
    assert torch.equal(nn_k[within], nn_a[within])
    assert (d2_k[~within] >= radius * radius).all()
    assert {k: v for k, v in ca.launches.items() if v} == {"nn_min_sparse": 1}


def _window(dev, b, s, m=1024, d_pad=8, seed=3):
    """Sparse-kernel arguments for an S-keyframe window on `dev`: lane
    b-1's last keyframe is empty, lane 0 has a tie across target tiles;
    attrs_t (B, S, D_pad, M) with zero entries. Returns (args, attrs_t),
    args = (src, src_bounds, tar, tar_bounds, valid, radius)."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(b, m, 2)) * 50).astype(np.float32)
    src = np.take_along_axis(src, np.argsort(src[..., :1], 1, kind="stable"), 1)
    shift = rng.normal(size=(1, s, 1, 2)) * np.arange(s)[None, :, None, None]
    tar = (src[:, None] + shift + rng.normal(size=(b, s, m, 2))).astype(np.float32)
    valid = rng.random((b, s, m)) < 0.9
    valid[b - 1, s - 1] = False
    tar[0, 0, 700] = tar[0, 0, 300]
    valid[0, 0, [300, 700]] = True
    src[0, 9] = tar[0, 0, 300]
    attrs_t = rng.normal(size=(b, s, d_pad, m)).astype(np.float32)
    attrs_t[rng.random(attrs_t.shape) < 0.1] = 0.0
    src, tar, valid, attrs_t = (torch.as_tensor(a).to(dev)
                                for a in (src, tar, valid, attrs_t))
    sb = ca.tile_bounds(src, torch.ones_like(valid[:, 0]), ca.TS_SPARSE)
    tb = ca.tile_bounds(tar, valid, ca.TT_SPARSE)
    radius = torch.full((b,), 3.0, device=dev)
    return (src, sb, tar, tb, valid, radius), attrs_t


@pytest.mark.parametrize("s", [1, 4, 50])
def test_kernels_d1_d2_e_bit_equal_to_c_and_twins(dev, s):
    """D1, D2 and E give kernel C's (nn, d2) bit for bit, and their twins'
    results, over B=3 lanes with an empty keyframe; E's g is the twin's."""
    args, attrs_t = _window(dev, 3, s)
    ca.reset_launches()
    nn_c, d2_c = ca.nn_min_sparse(*args)
    outs = {"multi": ca.nn_min_sparse_multi(*args),
            "unrolled": ca.nn_min_sparse_unrolled(*args)}
    nn_e, d2_e, g_e = ca.nn_min_sparse_attrs(*args[:5], attrs_t, args[5])
    nn_p, d2_p = ca.nn_min_sparse_plain(*args)
    _, _, g_p = ca.nn_min_sparse_attrs_plain(*args[:5], attrs_t, args[5])
    torch.cuda.synchronize()
    assert torch.equal(nn_c, nn_p) and torch.equal(d2_c, d2_p)
    for name, (nn, d2) in {**outs, "attrs": (nn_e, d2_e)}.items():
        assert torch.equal(nn, nn_c) and torch.equal(d2, d2_c), name
    assert torch.equal(g_e, g_p)
    assert torch.isinf(d2_c[2, s - 1]).all() and (nn_c[2, s - 1] == 0).all()
    assert (g_e[2, s - 1] == 0).all()
    assert nn_c[0, 0, 9].item() == 300
    assert set(ca.launches.values()) == {0, 1} and ca.launches["nn_min"] == 0


@pytest.mark.parametrize("b,s,m", [(1, 1, 2048), (3, 4, 2048), (2, 4, 3072),
                                   (2, 1, 1024)])
def test_kernels_b1_b2_bit_equal_to_a_and_twin(dev, b, s, m):
    """B1 and B2 give kernel A's (nn, d2) bit for bit, and the twin's, at
    the health check's reverse problem (S=1) and CFEAR-3's window (S=4),
    with both source tiles (512 rows up to M=2048, else 256), an empty
    keyframe (S=4) and a tie across target chunks."""
    src, tar, valid = _inputs(dev, b=b, s=s, m=m)
    if s == 1:
        valid[:, 0] = torch.rand(valid.shape[0], m, device=dev) < 0.9
        valid[0, 0, [300, 700]] = True
    ca.reset_launches()
    nn_a, d2_a = ca.nn_min(src, tar, valid)
    got = {"multi": ca.nn_min_multi(src, tar, valid),
           "unrolled": ca.nn_min_multi_unrolled(src, tar, valid)}
    nn_p, d2_p = ca.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    assert torch.equal(nn_a, nn_p) and torch.equal(d2_a, d2_p)
    for name, (nn, d2) in got.items():
        assert torch.equal(nn, nn_a) and torch.equal(d2, d2_a), name
    assert nn_a[0, 0, 9].item() == 300
    assert {k: v for k, v in ca.launches.items() if v} == {
        "nn_min": 1, "nn_min_multi": 1, "nn_min_multi_unrolled": 1}


def test_kernels_b1_b2_refuse_other_shapes(dev):
    src, tar, valid = _inputs(dev, b=1, s=2, m=1024)
    nn, _ = ca.nn_min_multi(src, tar, valid)                # B1 takes any S
    assert nn.shape == (1, 2, 1024)
    ca.reset_launches()
    with pytest.raises(ValueError, match="keyframe count"):
        ca.nn_min_multi_unrolled(src, tar, valid)
    with pytest.raises(ValueError, match="% 512"):
        ca.nn_min_multi(src[:, :768].contiguous(), tar, valid)
    assert not any(ca.launches.values())


@pytest.mark.parametrize("d_pad", [8, 16])
def test_kernel_e_takes_both_paddings(dev, d_pad):
    args, attrs_t = _window(dev, 2, 6, m=2048, d_pad=d_pad)
    nn, d2, g = ca.nn_min_sparse_attrs(*args[:5], attrs_t, args[5])
    want = ca.nn_min_sparse_attrs_plain(*args[:5], attrs_t, args[5])
    torch.cuda.synchronize()
    assert g.shape == (2, 6, d_pad, 2048)
    for a, b in zip((nn, d2, g), want):
        assert torch.equal(a, b)
    fin = torch.isfinite(d2)
    assert fin.any() and (~fin).any()


def test_kernel_d2_rejects_other_budgets(dev):
    args, _ = _window(dev, 1, 2, m=1536)
    nn, _ = ca.nn_min_sparse_multi(*args)                  # D1 takes any M
    assert nn.shape == (1, 2, 1536)
    ca.reset_launches()
    with pytest.raises(ValueError, match="512, 1024, 2048, 3072"):
        ca.nn_min_sparse_unrolled(*args)
    assert ca.launches["nn_min_sparse_unrolled"] == 0


def test_failed_launch_raises(dev, monkeypatch):
    """A launch the runtime refuses (the entry returns a CUDA error) raises
    and counts nothing; the wrapper never falls back to its twin."""
    from cfear_radarodometry_code_public_tpu_torch.ops import _build

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1                  # cudaErrorInvalidValue

    args, attrs_t = _window(dev, 1, 2)
    monkeypatch.setattr(_build, "library", lambda: Refusing())
    ca.reset_launches()
    for fn, extra in ((ca.nn_min_sparse, ()), (ca.nn_min_sparse_multi, ()),
                      (ca.nn_min_sparse_unrolled, ()),
                      (ca.nn_min_sparse_attrs, (attrs_t,))):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            fn(*args[:5], *extra, args[5])
    src, tar, valid = _inputs(dev, b=1, s=1, m=1024)
    for fn in (ca.nn_min, ca.nn_min_multi, ca.nn_min_multi_unrolled):
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            fn(src, tar, valid)
    assert not any(ca.launches.values())


def test_kernels_take_odd_sizes(dev):
    """Kernel A masks a ragged last block (Msrc % 128 != 0, M % 1024 != 0)."""
    src, tar, valid = _inputs(dev, b=3, s=2, m=1500)
    src = src[:, :1000].contiguous()
    nn_k, d2_k = ca.nn_min(src, tar, valid)
    nn_p, d2_p = ca.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)


def test_wrappers_raise_instead_of_falling_back(dev):
    src, tar, valid = _inputs(dev, b=1, s=1, m=512)
    with pytest.raises(ValueError, match="is on"):
        ca.nn_min(src, tar.cpu(), valid)
    with pytest.raises(TypeError, match="float32"):
        ca.nn_min(src.half(), tar, valid)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("cost,loss", chip_smoke.LM_CASES)
def test_kernel_f_matches_plain(dev, cost, loss, early_exit):
    """Kernel F at the slice's width against its twin (chip_smoke's
    tolerances); the other variant gives the same bits."""
    cfg, packed, pose0, _ = chip_smoke.lm_problem(
        np.random.default_rng(2), 8, 4, 1024, cost, loss)
    packed, pose0 = (torch.as_tensor(a).to(dev) for a in (packed, pose0))
    cuda_lm.reset_launches()
    got = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=early_exit)
    other = cuda_lm.lm_solve_fused(packed, pose0, cfg,
                                   early_exit=not early_exit)
    plain = cuda_lm.lm_solve_fused_plain(packed, pose0, cfg)
    torch.cuda.synchronize()
    assert cuda_lm.launches["lm_solve_fused"] == 2
    for a, b in zip(got, other):
        assert torch.equal(a, b)
    assert (got[0] - plain[0]).abs().max() <= chip_smoke.LM_POSE_TOL
    assert ((got[1] - plain[1]).abs() / plain[1]).max() <= chip_smoke.LM_COST_RTOL
    assert got[2].dtype == torch.int32 and (got[2] > 0).all()


def _cloud(dev, b, n=8192, seed=0):
    """Wall-like point clouds at the slice's point budget, on `dev`."""
    rng = np.random.default_rng(seed)
    xy = np.zeros((b, n, 2))
    for i in range(b):
        walls = [p0 + np.stack([np.cos(a) * t, np.sin(a) * t], -1)
                 for p0, a, t in ((rng.uniform(-90, 90, 2),
                                   rng.uniform(0, 2 * np.pi),
                                   rng.uniform(0, 60, n // 16))
                                  for _ in range(16))]
        xy[i] = np.concatenate(walls) + rng.normal(0, 0.2, (n, 2))
    intensity = rng.uniform(40, 220, (b, n))
    valid = rng.random((b, n)) < 0.95
    leaves = (xy.astype(np.float32), intensity.astype(np.float32), valid,
              valid & (rng.random((b, n)) < 0.5))
    return filtering.PointCloud(*(torch.as_tensor(a).to(dev) for a in leaves))


def test_kernel_g_matches_plain_and_repeats(dev):
    cfg = chip_smoke.slice_config(feature_backend="pallas")
    inputs = features._moment_inputs(_cloud(dev, 4), cfg)
    cuda_features.reset_launches()
    k1 = cuda_features.moment_accumulate(*inputs)
    k2 = cuda_features.moment_accumulate(*inputs)
    plain = cuda_features.moment_accumulate_plain(*inputs)
    torch.cuda.synchronize()
    assert cuda_features.launches["moment_accumulate"] == 2
    assert torch.equal(k1, k2)
    assert torch.equal(k1[:, 0], plain[:, 0]) and (k1[:, 0] > 0).sum() > 1000
    assert (k1[:, 9:] == 0).all()
    for r in range(1, 9):
        scale = plain[:, r].abs().max()
        assert (k1[:, r] - plain[:, r]).abs().max() <= chip_smoke.MOMENT_RTOL * scale


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_compute_cells_repeats_bit_for_bit(dev, backend):
    """The feature stage on the card gives the same bits on every call
    (no float atomics in either backend)."""
    cfg = chip_smoke.slice_config(feature_backend=backend)
    pts = _cloud(dev, 8, seed=1)
    first = features.compute_cells_batched(pts, cfg)
    for _ in range(2):
        again = features.compute_cells_batched(pts, cfg)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    assert (first.n > 200).all()


def test_new_wrappers_raise_instead_of_falling_back(dev):
    cfg, packed, pose0, _ = chip_smoke.lm_problem(
        np.random.default_rng(0), 2, 1, 512, "P2P", "Huber")
    packed = torch.as_tensor(packed).to(dev)
    with pytest.raises(ValueError, match="is on"):
        cuda_lm.lm_solve_fused(packed, torch.as_tensor(pose0), cfg)
    inputs = list(features._moment_inputs(_cloud(dev, 1),
                                          chip_smoke.slice_config()))
    inputs[1] = inputs[1].cpu()
    with pytest.raises(ValueError, match="is on"):
        cuda_features.moment_accumulate(*inputs)
