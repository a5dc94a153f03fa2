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


@pytest.mark.parametrize("shape", chip_smoke.A_SHAPES,
                         ids=lambda x: chip_smoke.shape_key(*x))
def test_kernel_a_bit_equal_at_main_path_shapes(dev, shape):
    """Kernel A at every shape of `chip_smoke.A_SHAPES` (Morton cells with
    a tie across chunks): bit-equal to its twin, one launch a call."""
    args = chip_smoke.a_inputs(dev, *shape)
    ca.reset_launches()
    nn_k, d2_k = ca.nn_min(*args)
    nn_p, d2_p = ca.nn_min_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)
    assert {k: v for k, v in ca.launches.items() if v} == {"nn_min": 1}
    assert nn_k[0, 0, 5].item() == 300


def dense_ties(seed=23, b=1, s=4, m_src=512, m=4096):
    """Kernel A's inputs (src, tar, valid) in numpy with exact ties
    straddling every boundary kernel A splits at, for any cluster size up
    to 8 at M=4096: groups of 16, slices of 64, chunks of 256 (also within
    one slice), ranks at multiples of 512, the staging pass at 2048 (also
    within one slice). The last keyframe is empty. Returns (case,
    [(keyframe, lo, row)])."""
    rng = np.random.default_rng(seed)
    src = (rng.normal(size=(b, m_src, 2)) * 40).astype(np.float32)
    tar = (rng.normal(size=(b, s, m, 2)) * 40).astype(np.float32)
    valid = rng.random((b, s, m)) < 0.85
    ties = [(0, 15, 16, 20), (0, 63, 64, 21), (1, 255, 256, 22),
            (1, 511, 512, 23), (2, 1023, 1024, 24), (0, 2047, 2048, 25),
            (2, 3071, 3072, 26), (1, 100, 4000, 27), (0, 50, 300, 28),
            (2, 2000, 2250, 29)]
    ties = [t for t in ties if t[2] < m and t[0] < s - 1]
    for k, lo, hi, row in ties:
        tar[:, k, hi] = tar[:, k, lo]
        valid[:, k, [lo, hi]] = True
        src[:, row] = tar[:, k, lo]
    valid[:, s - 1] = False
    return (src, tar, valid), [(k, lo, row) for k, lo, _, row in ties]


def _dense_ties(dev, **shape):
    """`dense_ties` on `dev`."""
    case, ties = dense_ties(**shape)
    return [torch.as_tensor(a).to(dev) for a in case], ties


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_kernel_a_ties_across_every_split(dev, monkeypatch, split):
    """Kernel A with each cluster size forced: bit-equal to its twin, the
    lowest index winning ties that straddle a group, slice, chunk, rank or
    pass boundary, an empty keyframe (+inf, 0)."""
    args, ties = _dense_ties(dev, b=2)
    monkeypatch.setattr(ca, "dense_split", lambda *shape: split)
    nn_k, d2_k = ca.nn_min(*args)
    nn_p, d2_p = ca.nn_min_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)
    for k, lo, row in ties:
        assert (nn_k[:, k, row] == lo).all() and (d2_k[:, k, row] == 0).all()
    assert torch.isinf(d2_k[:, -1]).all() and (nn_k[:, -1] == 0).all()


def test_kernel_a_refuses_a_split_it_cannot_take(dev, monkeypatch):
    """A cluster size the kernel does not take (3; 16; 8 over four target
    chunks) returns a CUDA error: the wrapper raises and counts nothing."""
    ca.reset_launches()
    for split, m in ((3, 4096), (16, 4096), (8, 1024)):
        args, _ = _dense_ties(dev, b=2, m=m)
        monkeypatch.setattr(ca, "dense_split", lambda *shape: split)
        with pytest.raises(RuntimeError, match="CUDA error"):
            ca.nn_min(*args)
    assert ca.launches["nn_min"] == 0


def test_kernel_a_refuses_misaligned_points(dev):
    """src or tar not on an 8-byte boundary (a view one float in): the
    wrapper raises ValueError and launches nothing."""
    src, tar, valid = _inputs(dev, b=1, s=2, m=1024)
    flat = torch.zeros(src.numel() + 1, device=dev)
    flat[1:] = src.reshape(-1)
    odd = flat[1:].view(src.shape)
    assert odd.is_contiguous() and odd.data_ptr() % 8
    ca.reset_launches()
    with pytest.raises(ValueError, match="8-byte"):
        ca.nn_min(odd, tar, valid)
    flat = torch.zeros(tar.numel() + 1, device=dev)
    flat[1:] = tar.reshape(-1)
    with pytest.raises(ValueError, match="8-byte"):
        ca.nn_min(src, flat[1:].view(tar.shape), valid)
    assert ca.launches["nn_min"] == 0


def test_kernel_a_lanes_and_repeats(dev):
    """Each lane of a B=8 call (forward window, M=2048) equals its own B=1
    call, which runs at another cluster size; two launches are
    bit-identical."""
    args = chip_smoke.a_inputs(dev, 8, 4, 2048, 2048, seed=4)
    assert ca.dense_split(8, 4, 2048, 2048) != ca.dense_split(1, 4, 2048,
                                                              2048)
    nn_k, d2_k = ca.nn_min(*args)
    again = ca.nn_min(*args)
    torch.cuda.synchronize()
    assert torch.equal(again[0], nn_k) and torch.equal(again[1], d2_k)
    for i in range(8):
        nn_1, d2_1 = ca.nn_min(*(a[i:i + 1].contiguous() for a in args))
        assert torch.equal(nn_1[0], nn_k[i]) and torch.equal(d2_1[0], d2_k[i])


def test_kernel_a_nonfinite_source_rows(dev):
    """Source rows at NaN and +-inf report (+inf, 0), as B1 and B2 do; the
    twin reports NaN at the first valid target for the NaN row (ROADMAP
    queue 3)."""
    src, tar, valid = _inputs(dev, b=1, s=1, m=1024)
    valid[0, 0] = True
    valid[0, 0, 0] = False
    src[0, 3] = float("nan")
    src[0, 4, 0] = float("inf")
    src[0, 5, 0], src[0, 5, 1] = -float("inf"), float("inf")
    nn_k, d2_k = ca.nn_min(src, tar, valid)
    nn_b1, d2_b1 = ca.nn_min_multi(src, tar, valid)
    nn_p, d2_p = ca.nn_min_plain(src, tar, valid)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_b1) and torch.equal(d2_k, d2_b1)
    assert torch.isinf(d2_k[0, 0, 3:6]).all() and (nn_k[0, 0, 3:6] == 0).all()
    assert nn_p[0, 0, 3] == 1 and d2_p[0, 0, 3].isnan()
    rest = torch.ones(1024, dtype=torch.bool, device=dev)
    rest[3] = False
    assert torch.equal(nn_k[0, 0, rest], nn_p[0, 0, rest])
    assert torch.equal(d2_k[0, 0, rest], d2_p[0, 0, rest])


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


@pytest.mark.parametrize("shape", chip_smoke.C_SHAPES,
                         ids=lambda x: chip_smoke.shape_key(*x))
def test_kernel_c_bit_equal_at_main_path_shapes(dev, shape):
    """Kernel C at every main-path shape (`chip_smoke.C_SHAPES`, Morton
    cells with an empty keyframe and a tie across target tiles), both
    radii: bit-equal to its twin, one launch a call."""
    for radius in (2.0, 4.0):
        args = chip_smoke.c_inputs(dev, *shape, radius=radius)
        ca.reset_launches()
        nn_k, d2_k = ca.nn_min_sparse(*args)
        nn_p, d2_p = ca.nn_min_sparse_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p), radius
        assert {k: v for k, v in ca.launches.items() if v} == {"nn_min_sparse": 1}
        assert torch.isinf(d2_k[-1, -1]).all() and (nn_k[-1, -1] == 0).all()
        assert nn_k[0, 0, 5].item() == 300


def _split_window(dev, b=2, s=3, m=4096):
    """Sparse-kernel arguments with exact ties straddling every boundary
    kernel C splits at, for any cluster size up to 8 at M=4096: groups of
    16, slices of 128, tiles of 512, ranks at multiples of 512; above that,
    where kernel D1 stages a keyframe's tiles in passes of 8, a tie across
    the first pass boundary (4096) and one across its first window of 32
    tiles (16384). Keyframe 1 of the last lane is empty. Returns (args,
    [(keyframe, lo, row)])."""
    rng = np.random.default_rng(11)
    src = (rng.normal(size=(b, 512, 2)) * 40).astype(np.float32)
    src = np.take_along_axis(src, np.argsort(src[..., :1], 1, kind="stable"), 1)
    tar = (rng.normal(size=(b, s, m, 2)) * 40).astype(np.float32)
    valid = rng.random((b, s, m)) < 0.85
    ties = [(0, 15, 16, 20), (0, 127, 128, 21), (1, 511, 512, 22),
            (2, 1023, 1024, 23), (0, 2047, 2048, 24), (2, 3071, 3072, 25),
            (1, 100, 4000, 26), (0, 4095, 4096, 27), (2, 16383, 16384, 28)]
    ties = [t for t in ties if t[2] < m]
    for k, lo, hi, row in ties:
        tar[:, k, hi] = tar[:, k, lo]
        valid[:, k, [lo, hi]] = True
        src[:, row] = tar[:, k, lo]
    valid[b - 1, 1] = False
    src, tar, valid = (torch.as_tensor(a).to(dev) for a in (src, tar, valid))
    sb = ca.tile_bounds(src, torch.ones_like(valid[:, 0, :512]), ca.TS_SPARSE)
    tb = ca.tile_bounds(tar, valid, ca.TT_SPARSE)
    return ((src, sb, tar, tb, valid, torch.full((b,), 3.0, device=dev)),
            [(k, lo, row) for k, lo, _, row in ties])


@pytest.mark.parametrize("split", [0, 1, 2, 4, 8])
def test_kernel_c_ties_across_every_split(dev, monkeypatch, split):
    """Kernel C with each cluster size forced (0: the one-block form):
    bit-equal to its twin, the lowest index winning ties that straddle a
    group, slice, tile or rank boundary, an empty keyframe (+inf, 0)."""
    args, ties = _split_window(dev)
    monkeypatch.setattr(ca, "sparse_split", lambda *shape: split)
    nn_k, d2_k = ca.nn_min_sparse(*args)
    nn_p, d2_p = ca.nn_min_sparse_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)
    for k, lo, row in ties:
        assert (nn_k[0, k, row] == lo).item() and (d2_k[0, k, row] == 0).item()
    assert torch.isinf(d2_k[-1, 1]).all() and (nn_k[-1, 1] == 0).all()


def test_kernel_c_refuses_a_split_it_cannot_take(dev, monkeypatch):
    """A cluster size the kernel does not take (3; 8 over two target
    tiles; 1 over more tiles than a CTA stages) returns a CUDA error: the
    wrapper raises and counts nothing."""
    ca.reset_launches()
    for split, m in ((3, 4096), (8, 1024),
                     (1, (ca.SPLIT_MAX_TILES + 1) * ca.TT_SPARSE)):
        args, _ = _split_window(dev, m=m)
        monkeypatch.setattr(ca, "sparse_split", lambda *shape: split)
        with pytest.raises(RuntimeError, match="CUDA error"):
            ca.nn_min_sparse(*args)
    assert ca.launches["nn_min_sparse"] == 0


def _split_attrs(dev, args, d_pad=8, seed=13):
    """Random attribute columns attrs_t (B, S, D_pad, M) for the keyframes
    of `args` (a `_split_window`), a tenth of them zero."""
    b, s, m = args[4].shape
    rng = np.random.default_rng(seed)
    at = rng.normal(size=(b, s, d_pad, m)).astype(np.float32)
    at[rng.random(at.shape) < 0.1] = 0.0
    return torch.as_tensor(at).to(dev)


@pytest.mark.parametrize("split", [0, 1, 2, 4, 8])
def test_kernel_e_ties_across_every_split(dev, monkeypatch, split):
    """Kernel E with each cluster size forced (0: its one-block form), on
    C's tie window: (nn, d2) bit-equal to kernel C's and the twin's, g to
    the twin's, the tie winners' columns copied, zeros on the empty
    keyframe; one launch of each."""
    args, ties = _split_window(dev)
    at = _split_attrs(dev, args)
    monkeypatch.setattr(ca, "sparse_split", lambda *shape: split)
    ca.reset_launches()
    nn_e, d2_e, g_e = ca.nn_min_sparse_attrs(*args[:5], at, args[5])
    nn_c, d2_c = ca.nn_min_sparse(*args)
    nn_p, d2_p, g_p = ca.nn_min_sparse_attrs_plain(*args[:5], at, args[5])
    torch.cuda.synchronize()
    assert torch.equal(nn_c, nn_p) and torch.equal(d2_c, d2_p)
    assert torch.equal(nn_e, nn_c) and torch.equal(d2_e, d2_c)
    assert torch.equal(g_e, g_p)
    for k, lo, row in ties:
        assert (nn_e[0, k, row] == lo).item()
        assert torch.equal(g_e[0, k, :, row], at[0, k, :, lo])
    assert torch.isinf(d2_e[-1, 1]).all() and (g_e[-1, 1] == 0).all()
    assert {k: v for k, v in ca.launches.items() if v} == {
        "nn_min_sparse_attrs": 1, "nn_min_sparse": 1}


def test_kernel_e_refuses_a_split_it_cannot_take(dev, monkeypatch):
    """A cluster size kernel E does not take (3; 8 over two target tiles;
    1 over more tiles than a CTA stages), as kernel C: a CUDA error, the
    wrapper raises and counts nothing."""
    ca.reset_launches()
    for split, m in ((3, 4096), (8, 1024),
                     (1, (ca.SPLIT_MAX_TILES + 1) * ca.TT_SPARSE)):
        args, _ = _split_window(dev, m=m)
        at = _split_attrs(dev, args)
        monkeypatch.setattr(ca, "sparse_split", lambda *shape: split)
        with pytest.raises(RuntimeError, match="CUDA error"):
            ca.nn_min_sparse_attrs(*args[:5], at, args[5])
    assert ca.launches["nn_min_sparse_attrs"] == 0


def test_kernel_c_k16_window_and_lanes(dev):
    """The K16 case (S=50, keyframes 16-49 invalid, their tiles skipped):
    bit-equal to the twin; each lane of a B=8 call equals its B=1 call
    and two launches are bit-identical."""
    args = list(chip_smoke.c_inputs(dev, 8, 50, 1024, 1024))
    args[4] = args[4].clone()
    args[4][:, 16:] = False
    args[3] = ca.tile_bounds(args[2], args[4], ca.TT_SPARSE)
    nn_k, d2_k = ca.nn_min_sparse(*args)
    again = ca.nn_min_sparse(*args)
    nn_p, d2_p = ca.nn_min_sparse_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nn_k, nn_p) and torch.equal(d2_k, d2_p)
    assert torch.equal(again[0], nn_k) and torch.equal(again[1], d2_k)
    assert torch.isinf(d2_k[:, 16:]).all() and (nn_k[:, 16:] == 0).all()
    for i in range(8):
        nn_1, d2_1 = ca.nn_min_sparse(*(a[i:i + 1].contiguous() for a in args))
        assert torch.equal(nn_1[0], nn_k[i]) and torch.equal(d2_1[0], d2_k[i])


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
    hi = 700 if m > 700 else 400       # across target tiles where M > 512
    tar[0, 0, hi] = tar[0, 0, 300]
    valid[0, 0, [300, hi]] = True
    src[0, 9] = tar[0, 0, 300]
    attrs_t = rng.normal(size=(b, s, d_pad, m)).astype(np.float32)
    attrs_t[rng.random(attrs_t.shape) < 0.1] = 0.0
    src, tar, valid, attrs_t = (torch.as_tensor(a).to(dev)
                                for a in (src, tar, valid, attrs_t))
    sb = ca.tile_bounds(src, torch.ones_like(valid[:, 0]), ca.TS_SPARSE)
    tb = ca.tile_bounds(tar, valid, ca.TT_SPARSE)
    radius = torch.full((b,), 3.0, device=dev)
    return (src, sb, tar, tb, valid, radius), attrs_t


@pytest.mark.parametrize("m", [512, 1024, 3072])
@pytest.mark.parametrize("s", [1, 4, 50])
def test_kernels_d1_d2_e_bit_equal_to_c_and_twins(dev, s, m):
    """D1, D2 and E give kernel C's (nn, d2) bit for bit, and their twins'
    results, over B=3 lanes with an empty keyframe, at one, two and six
    target tiles; E's g is the twin's."""
    args, attrs_t = _window(dev, 3, s, m)
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
                                   (2, 1, 1024), (2, 4, 1152), (1, 1, 1152),
                                   (1, 4, 4096)])
def test_kernels_b1_b2_bit_equal_to_a_and_twin(dev, b, s, m):
    """B1 and B2 give kernel A's (nn, d2) bit for bit, and the twin's, at
    the health check's reverse problem (S=1) and CFEAR-3's window (S=4),
    with both of the reference's source tiles (512 rows up to M=2048, else
    256), M=1,152 (a padded tail chunk), an empty keyframe (S=4) and a tie
    across target chunks."""
    src, tar, valid = _inputs(dev, b=b, s=s, m=m)
    if not ca.supported_multi(m, m):       # M=1,152: the source tile is 512
        src = src[:, :ca.ts_multi(m)].contiguous()
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


# (S, keyframe groups, cluster size): every pair `multi_split` gives at the
# smoke's shapes (`chip_smoke.b_shapes()`) and every group count at S=4
B_SPLITS = ((4, 4, 1), (4, 4, 2), (4, 4, 4), (4, 4, 8), (4, 1, 1), (4, 2, 1),
            (4, 3, 1), (1, 1, 1), (1, 1, 2), (1, 1, 4), (1, 1, 8),
            (2, 2, 4), (3, 3, 4), (8, 8, 4), (3, 3, 8))


@pytest.mark.parametrize("s,groups,split", B_SPLITS)
def test_kernels_b1_b2_ties_across_every_split(dev, monkeypatch, s, groups,
                                               split):
    """B1 and B2 with each (keyframe groups, cluster size) forced, on
    `dense_ties` (M=4096: two passes of the stage at one rank, ties across
    a group, slice, chunk, rank and pass boundary, B=2): bit-equal to
    kernel A and the twin, an empty keyframe (+inf, 0). The list holds
    every pair `multi_split` gives at the smoke's shapes."""
    assert {ca.multi_split(*shape) for shape in chip_smoke.b_shapes()} <= {
        (g, c) for _, g, c in B_SPLITS}
    (src, tar, valid), ties = _dense_ties(dev, b=2, s=max(s, 2))
    if s == 1:                      # keyframe 0 of two: the other is empty
        tar, valid = tar[:, :1].contiguous(), valid[:, :1].contiguous()
        ties = [t for t in ties if t[0] == 0]
    args = (src, tar, valid)
    monkeypatch.setattr(ca, "multi_split", lambda *shape: (groups, split))
    ca.reset_launches()
    nn_a, d2_a = ca.nn_min(*args)
    got = {"multi": ca.nn_min_multi(*args),
           "unrolled": ca.nn_min_multi_unrolled(*args)}
    nn_p, d2_p = ca.nn_min_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(nn_a, nn_p) and torch.equal(d2_a, d2_p)
    for name, (nn, d2) in got.items():
        assert torch.equal(nn, nn_a) and torch.equal(d2, d2_a), name
    for k, lo, row in ties:
        assert (nn_a[:, k, row] == lo).all() and (d2_a[:, k, row] == 0).all()
    if s > 1:
        assert torch.isinf(d2_a[:, -1]).all() and (nn_a[:, -1] == 0).all()
    assert {k: v for k, v in ca.launches.items() if v} == {
        "nn_min": 1, "nn_min_multi": 1, "nn_min_multi_unrolled": 1}


def test_kernels_b1_b2_refuse_a_split_they_cannot_take(dev, monkeypatch):
    """A (keyframe groups, cluster size) the kernels do not take (0 or S
    + 1 groups; a cluster of 3 or 16; a cluster above 1 with fewer groups
    than S; a cluster of 8 over four target chunks) returns a CUDA error:
    the wrappers raise and count nothing."""
    src, tar, valid = _inputs(dev, b=1, s=4, m=1024)
    ca.reset_launches()
    for groups, split in ((0, 1), (5, 1), (4, 3), (4, 16), (2, 2), (4, 8)):
        monkeypatch.setattr(ca, "multi_split", lambda *shape: (groups, split))
        for fn in (ca.nn_min_multi, ca.nn_min_multi_unrolled):
            with pytest.raises(RuntimeError, match="CUDA error"):
                fn(src, tar, valid)
    assert not any(ca.launches.values())


def test_kernels_b1_b2_refuse_misaligned_targets(dev):
    """tar not on a 16-byte boundary or valid not on a 4-byte one (views
    one point and one byte in): B1 and B2 copy them 16 and 4 bytes at a
    time, so the wrappers raise ValueError and launch nothing."""
    src, tar, valid = _inputs(dev, b=1, s=1, m=1024)
    flat = torch.zeros(tar.numel() + 2, device=dev)
    flat[2:] = tar.reshape(-1)
    odd_t = flat[2:].view(tar.shape)
    vflat = torch.zeros(valid.numel() + 1, dtype=torch.bool, device=dev)
    vflat[1:] = valid.reshape(-1)
    odd_v = vflat[1:].view(valid.shape)
    assert odd_t.data_ptr() % 16 and odd_v.data_ptr() % 4
    ca.reset_launches()
    for fn in (ca.nn_min_multi, ca.nn_min_multi_unrolled):
        for t, v in ((odd_t, valid), (tar, odd_v)):
            with pytest.raises(ValueError, match="16-byte"):
                fn(src, t, v)
    assert not any(ca.launches.values())


def test_kernels_b1_b2_refuse_other_shapes(dev):
    """B1 and B2 refuse only what the reference's refuse, Msrc %
    ts_multi(M), and launch nothing then. B2 at keyframe counts without a
    static instance (S = 2, 3, 8: the runtime-count instance) and at target
    budgets that are not a multiple of 128 (1,500) or of 4 (1,001, staged
    element by element) is bit-equal to kernel A, B1 and the twin, each
    call counted as one launch of its own kernel."""
    for b, s, m_src, m in ((2, 2, 1024, 1024), (1, 3, 1024, 1024),
                           (2, 8, 1024, 1024), (3, 2, 1024, 1500),
                           (2, 3, 512, 1001)):
        src, tar, valid = _inputs(dev, b=b, s=s, m=m)
        src = src[:, :m_src].contiguous()
        assert s not in ca.UNROLLED_S or m % 128
        ca.reset_launches()
        nn_a, d2_a = ca.nn_min(src, tar, valid)
        got = {"multi": ca.nn_min_multi(src, tar, valid),
               "unrolled": ca.nn_min_multi_unrolled(src, tar, valid)}
        nn_p, d2_p = ca.nn_min_plain(src, tar, valid)
        torch.cuda.synchronize()
        assert torch.equal(nn_a, nn_p) and torch.equal(d2_a, d2_p)
        for name, (nn, d2) in got.items():
            assert torch.equal(nn, nn_a) and torch.equal(d2, d2_a), \
                (name, b, s, m_src, m)
        assert torch.isinf(d2_a[:, s - 1]).all()           # empty keyframe
        assert {k: v for k, v in ca.launches.items() if v} == {
            "nn_min": 1, "nn_min_multi": 1, "nn_min_multi_unrolled": 1}
    src, tar, valid = _inputs(dev, b=1, s=2, m=1024)
    ca.reset_launches()
    for fn in (ca.nn_min_multi, ca.nn_min_multi_unrolled):
        with pytest.raises(ValueError, match="% 512"):
            fn(src[:, :768].contiguous(), tar, valid)
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


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_kernels_d1_d2_ties_across_every_group_count(dev, monkeypatch, groups):
    """D1 and D2 with each keyframe-group count forced: bit-equal to kernel
    C and the twin, the lowest index winning ties that straddle a group,
    slice, tile, stage-pass or live-window boundary, an empty keyframe
    (+inf, 0). D1 at 8 target tiles (one pass), 9 (two passes of the
    8-tile stage) and 40 (five, over two windows of 32 tiles); D2 at 6."""
    monkeypatch.setattr(ca, "walk_groups", lambda *shape: groups)
    for fn, m in ((ca.nn_min_sparse_multi, 4096),
                  (ca.nn_min_sparse_multi, 9 * ca.TT_SPARSE),
                  (ca.nn_min_sparse_multi, 40 * ca.TT_SPARSE),
                  (ca.nn_min_sparse_unrolled, 3072)):
        args, ties = _split_window(dev, m=m)
        ca.reset_launches()
        nn_k, d2_k = fn(*args)
        nn_c, d2_c = ca.nn_min_sparse(*args)
        nn_p, d2_p = ca.nn_min_sparse_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(nn_c, nn_p) and torch.equal(d2_c, d2_p)
        assert torch.equal(nn_k, nn_c) and torch.equal(d2_k, d2_c), (fn, m)
        for k, lo, row in ties:
            assert (nn_k[0, k, row] == lo).item(), (m, k, lo)
        assert torch.isinf(d2_k[-1, 1]).all() and (nn_k[-1, 1] == 0).all()
        assert {k: v for k, v in ca.launches.items() if v} == {
            fn.__name__: 1, "nn_min_sparse": 1}


def test_kernels_d1_d2_refuse_a_group_count_they_cannot_take(dev, monkeypatch):
    """A keyframe-group count outside [1, S] (0; S + 1) returns a CUDA
    error: the wrappers raise and count nothing."""
    args, _ = _window(dev, 2, 3)
    ca.reset_launches()
    for groups in (0, 4):
        monkeypatch.setattr(ca, "walk_groups", lambda *shape: groups)
        for fn in (ca.nn_min_sparse_multi, ca.nn_min_sparse_unrolled):
            with pytest.raises(RuntimeError, match="CUDA error"):
                fn(*args)
    assert not any(ca.launches.values())


def test_kernel_d2_rejects_other_budgets(dev):
    """D2 refuses only what the reference's D2 refuses (Msrc % 256, M %
    512) and launches nothing then. At target budgets without a static
    instance (1,536 and 4,096: the runtime-count instance) it is bit-equal
    to kernel C, D1 and the twin, each call counted as one launch of its
    own kernel."""
    for b, s, m in ((1, 2, 1536), (3, 4, 1536), (1, 2, 4096), (2, 16, 4096)):
        assert m not in ca.UNROLLED_M
        args, _ = _window(dev, b, s, m=m)
        ca.reset_launches()
        nn_c, d2_c = ca.nn_min_sparse(*args)
        got = {"multi": ca.nn_min_sparse_multi(*args),
               "unrolled": ca.nn_min_sparse_unrolled(*args)}
        nn_p, d2_p = ca.nn_min_sparse_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(nn_c, nn_p) and torch.equal(d2_c, d2_p)
        for name, (nn, d2) in got.items():
            assert torch.equal(nn, nn_c) and torch.equal(d2, d2_c), \
                (name, b, s, m)
        assert {k: v for k, v in ca.launches.items() if v} == {
            "nn_min_sparse": 1, "nn_min_sparse_multi": 1,
            "nn_min_sparse_unrolled": 1}
    args, _ = _window(dev, 1, 2, m=1536)
    ca.reset_launches()
    with pytest.raises(ValueError, match="% 512"):
        ca.nn_min_sparse_unrolled(*args[:2], args[2][:, :, :1000].contiguous(),
                                  args[3], args[4][:, :, :1000].contiguous(),
                                  args[5])
    with pytest.raises(ValueError, match="% 256"):
        ca.nn_min_sparse_unrolled(args[0][:, :300].contiguous(),
                                  args[1][:, :1], *args[2:])
    assert not any(ca.launches.values())


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
    tolerances: the loss's own pose bound, and for `LM_STEPS_FREE` losses
    the pose only on lanes whose accepted steps agree); the other variant
    gives the same bits."""
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
    same = got[2] == plain[2]
    assert same.all() or loss in chip_smoke.LM_STEPS_FREE
    assert (got[0] - plain[0])[same].abs().max() <= \
        chip_smoke.LM_POSE_TOL_LOSS.get(loss, chip_smoke.LM_POSE_TOL)
    assert ((got[1] - plain[1]).abs() / plain[1]).max() <= chip_smoke.LM_COST_RTOL
    # every lane takes a step, but on Tukey's problem, where the reference's
    # own two solvers take none on two lanes (tools/tool_spread_torch.py
    # --problems lm: steps 1, 0, 1, 1, 0, 1, 20, 1)
    assert got[2].dtype == torch.int32 and ((got[2] > 0).all()
                                            or loss == "Tukey")


def _lm_rows(dev, b, n, cost="P2P", loss="Cauchy", seed=4):
    """`b` packed problems of exactly `n` rows on `dev` (the smoke's
    problem over keyframes of 1024 cells, cut to n)."""
    cfg, packed, pose0, _ = chip_smoke.lm_problem(
        np.random.default_rng(seed), b, -(-n // 1024), 1024, cost, loss)
    packed = np.ascontiguousarray(packed[:, :, :n])
    return (cfg, *(torch.as_tensor(a).to(dev) for a in (packed, pose0)))


# one CTA (1,000), clusters of 8 (4,096; 8,192; 8,200: a ragged share;
# 16,384; 51,200: shared memory full) and of 16 (153,600: half the rows
# streamed from L2)
@pytest.mark.parametrize("n", [1000, 4096, 8192, 8200, 16384, 51200, 153600])
def test_kernel_f_widths_and_lane_independence(dev, n):
    """At every cluster size: within tolerance of the twin with equal
    steps, early exit == masked, and lane i of a B=8 call bit-equal to a
    B=1 call of lane i."""
    cfg, packed, pose0 = _lm_rows(dev, 8, n)
    got = cuda_lm.lm_solve_fused(packed, pose0, cfg)
    masked = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=False)
    plain = cuda_lm.lm_solve_fused_plain(packed, pose0, cfg)
    torch.cuda.synchronize()
    for a, b in zip(got, masked):
        assert torch.equal(a, b)
    assert (got[0] - plain[0]).abs().max() <= chip_smoke.LM_POSE_TOL
    assert ((got[1] - plain[1]).abs() / plain[1]).max() <= chip_smoke.LM_COST_RTOL
    assert torch.equal(got[2], plain[2]) and (got[2] > 0).all()
    for i in (0, 3, 7):
        alone = cuda_lm.lm_solve_fused(packed[i:i + 1].contiguous(),
                                       pose0[i:i + 1].contiguous(), cfg)
        for a, b in zip(got, alone):
            assert torch.equal(a[i], b[0]), f"lane {i}"


# the single-lane solves of the 832-bin CLI paths (4 x 3072 cells) and of
# the raw cells (4 x 4096, `chip_smoke.A_RAW`'s path)
@pytest.mark.parametrize("n", [12288, 16384])
def test_kernel_f_single_lane_widths(dev, n):
    """One lane (B=1) at the widths the `cli-kvarntorp`, `cli-volvo` and
    `cli-raw` paths solve: within tolerance of the twin with equal steps,
    early exit == masked, two calls bit-identical."""
    cfg, packed, pose0 = _lm_rows(dev, 1, n, loss="Huber")
    got = cuda_lm.lm_solve_fused(packed, pose0, cfg)
    again = cuda_lm.lm_solve_fused(packed, pose0, cfg)
    masked = cuda_lm.lm_solve_fused(packed, pose0, cfg, early_exit=False)
    plain = cuda_lm.lm_solve_fused_plain(packed, pose0, cfg)
    torch.cuda.synchronize()
    for a, b, c in zip(got, again, masked):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (got[0] - plain[0]).abs().max() <= chip_smoke.LM_POSE_TOL
    assert ((got[1] - plain[1]).abs() / plain[1]).max() <= chip_smoke.LM_COST_RTOL
    assert torch.equal(got[2], plain[2]) and (got[2] > 0).all()


@pytest.mark.parametrize("cost,loss", [("P2P", "Huber"), ("P2L", "Cauchy")])
def test_kernel_f_keeps_a_zero_weight_inf_row(dev, cost, loss):
    """A row with w = 0 that holds inf is evaluated like any other, as the
    twin does: both end where they started, with a non-finite cost."""
    cfg, packed, pose0 = _lm_rows(dev, 2, 1000, cost, loss)
    packed[1, 2, 17] = float("inf")
    packed[1, 4, 17] = 0.0
    got = cuda_lm.lm_solve_fused(packed, pose0, cfg)
    plain = cuda_lm.lm_solve_fused_plain(packed, pose0, cfg)
    torch.cuda.synchronize()
    assert (got[0][0] - plain[0][0]).abs().max() <= chip_smoke.LM_POSE_TOL
    assert torch.equal(got[2], plain[2]) and got[2][1] == 0
    assert torch.equal(got[0][1], pose0[1]) and not torch.isfinite(got[1][1])
    assert not torch.isfinite(plain[1][1])


def test_kernel_f_refused_launch_raises(dev):
    """More shared memory than a block may have: the launch is refused,
    the wrapper raises and counts nothing; the next launch works."""
    cfg, packed, pose0 = _lm_rows(dev, 1, 16384)
    cuda_lm.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_lm._launch(packed, pose0, cfg, cluster=1, smem_rows=16384)
    assert cuda_lm.launches["lm_solve_fused"] == 0
    auto = cuda_lm.lm_solve_fused(packed, pose0, cfg)
    for cluster in (1, 2, 4, 16):       # one CTA streams 60% of the rows
        forced = cuda_lm._launch(packed, pose0, cfg, cluster=cluster)
        torch.cuda.synchronize()
        assert (forced[0] - auto[0]).abs().max() <= chip_smoke.LM_POSE_TOL
        assert torch.equal(forced[2], auto[2])
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_lm._launch(packed, pose0, cfg, cluster=3)


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


def _g_check(got, plain):
    """Rows 0-8 bit-equal to the twin's, rows 9-15 zero."""
    assert torch.equal(got[:, :9], plain[:, :9])
    assert (got[:, 9:] == 0).all()


def test_kernel_g_matches_plain_and_repeats(dev):
    cfg = chip_smoke.slice_config(feature_backend="pallas")
    inputs = features._moment_inputs(_cloud(dev, 4), cfg)
    cuda_features.reset_launches()
    k1 = cuda_features.moment_accumulate(*inputs)
    k2 = cuda_features.moment_accumulate(*inputs)
    plain = cuda_features.moment_accumulate_plain(*inputs)
    torch.cuda.synchronize()
    assert (cuda_features.launches["moment_accumulate"]
            == 2 * cuda_features.LAUNCHES_PER_CALL)
    assert torch.equal(k1, k2)
    assert torch.equal(k1[:, 0], plain[:, 0]) and (k1[:, 0] > 0).sum() > 1000
    assert (k1[:, 9:] == 0).all()
    for r in range(1, 9):
        scale = plain[:, r].abs().max()
        assert (k1[:, r] - plain[:, r]).abs().max() <= chip_smoke.MOMENT_RTOL * scale
    _g_check(k1, plain)
    assert (k1[:, 0] > 32).any()          # some lists are longer than a warp


def test_kernel_g_lane_of_batch_equals_single(dev):
    cfg = chip_smoke.slice_config(feature_backend="pallas")
    inputs = features._moment_inputs(_cloud(dev, 8, seed=2), cfg)
    batched = cuda_features.moment_accumulate(*inputs)
    for i in range(8):
        alone = cuda_features.moment_accumulate(
            *(t[i:i + 1].contiguous() for t in inputs[:5]), *inputs[5:])
        assert torch.equal(alone[0], batched[i]), f"lane {i}"


@pytest.mark.parametrize("crowd", [33, 1000, 2000, 5000])
def test_kernel_g_long_list(dev, crowd):
    """One voxel holds `crowd` points, its neighbours none: no cap on a
    cell's list drops hits, and the sum keeps (point, offset) order."""
    cfg = chip_smoke.slice_config(feature_backend="pallas")
    leaves = chip_smoke.crowded_cloud(np.random.default_rng(crowd), 2, 8192,
                                      cfg, crowd)
    inputs = features._moment_inputs(
        filtering.PointCloud(*(torch.as_tensor(a).to(dev) for a in leaves)),
        cfg)
    k1 = cuda_features.moment_accumulate(*inputs)
    k2 = cuda_features.moment_accumulate(*inputs)
    plain = cuda_features.moment_accumulate_plain(*inputs)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    _g_check(k1, plain)
    assert (k1[:, 0].amax(-1) >= crowd).all()


def test_kernel_g_takes_repeated_targets(dev):
    """Arbitrary packs: a point may hit one cell through two offsets, and
    every list is long (73,728 hits over 128 cells)."""
    rng = np.random.default_rng(8)
    b, n, n_off, c_pre = 2, 8192, 9, 128
    trank = rng.integers(0, c_pre + 40, (b, n_off, n))
    pack = np.concatenate(
        [rng.uniform(-1.5, 1.5, (b, 2, n)), rng.uniform(0, 160, (b, 1, n)),
         rng.uniform(-100, 100, (b, 2, n)), trank < c_pre,
         np.minimum(trank, c_pre), np.zeros((b, 1, n))], 1).astype(np.float32)
    pack = torch.as_tensor(pack).to(dev)
    bounds = [torch.zeros((b, k), device=dev) for k in
              (c_pre // 128, c_pre // 128, n // 512, n // 512)]
    offsets_m = tuple((dx * 3.0, dy * 3.0) for dx in (-1, 0, 1)
                      for dy in (-1, 0, 1))
    got = cuda_features.moment_accumulate(pack, *bounds, offsets_m, n_off,
                                          c_pre)
    plain = cuda_features.moment_accumulate_plain(pack, *bounds, offsets_m,
                                                  n_off, c_pre)
    torch.cuda.synchronize()
    _g_check(got, plain)
    assert got[:, 0].min() > 32


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


def _small_cfg(**filt):
    import dataclasses
    from cfear_radarodometry_code_public_tpu_torch import preset
    cfg = preset("CFEAR-3", dataset="synthetic")
    return cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=512,
                                    point_budget=2048),
        filter=dataclasses.replace(cfg.filter, k_strongest=12, **filt))


@pytest.mark.parametrize("filt", [{}, {"z_min_quantile": 0.98},
                                  {"method": "cacfar"}])
def test_image_filter_on_the_card_equals_the_cpu(dev, filt):
    """`filter_polar_image` on the card gives the CPU's cloud on the same
    sweeps (torch ops on both): masks, peaks and intensities exact, each
    point within 1e-5 m plus 1e-6 of its range (CUDA's and the CPU's f32
    sin/cos differ by an ulp)."""
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    cfg = _small_cfg(**filt)
    images, _ = synthetic.make_sequence(seed=3, n_frames=3, cfg=cfg)
    cpu = filtering.filter_polar_image(torch.as_tensor(images), cfg)
    card = filtering.filter_polar_image(torch.as_tensor(images).to(dev), cfg)
    for name in ("valid", "peak", "intensity"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    v = cpu.valid
    assert v.any()
    dist = (card.xy.cpu()[v] - cpu.xy[v]).norm(dim=-1)
    assert (dist <= 1e-5 + 1e-6 * cpu.xy[v].norm(dim=-1)).all(), \
        dist.max().item()


def test_image_ingest_runner_equals_host_ingest_on_the_card(dev):
    """The runner's default image ingest (raw sweeps through pinned host
    memory, a ragged last chunk) against host ingest on the card: within
    1e-4 with identical keyframe flags, and a second image run bit for
    bit."""
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    from cfear_radarodometry_code_public_tpu_torch.models import odometry
    cfg = _small_cfg()
    images, _ = synthetic.make_sequence(seed=3, n_frames=11, cfg=cfg)
    runs = []
    for ingest in ("image", "image", "host"):
        r = odometry.OdometryRunner(cfg, ingest=ingest, device=dev, chunk=4)
        r.process(images)
        runs.append((r.trajectory(), r.frame_outputs()))
    (a, oa), (b, _), (h, oh) = runs
    assert np.array_equal(a, b)
    assert np.array_equal(oa.fused, oh.fused) and oa.success.all()
    assert np.abs(a - h).max() < 1e-4


def test_optimize_on_the_card_equals_the_cpu_and_repeats(dev):
    """The port's `optimize` at the SLAM pass's 40 GN x 400 PCG on the
    `slam` golden's graph: two card runs bit-identical, and the card's
    poses within chip_smoke.SLAM_OPT_TOL of the CPU's and of JAX's."""
    from cfear_radarodometry_code_public_tpu_torch.models import posegraph
    with np.load(chip_smoke.GOLDEN_SLAM) as z:
        g = {k: z[k] for k in z.files}
    tol = chip_smoke.SLAM_OPT_TOL
    runs = [posegraph.optimize(chip_smoke.golden_graph(g, d),
                               **chip_smoke.SLAM_ITERS)[0].poses
            for d in (dev, dev, torch.device("cpu"))]
    assert torch.equal(runs[0], runs[1])
    card = runs[0].cpu().numpy()
    for want in (runs[2].numpy(), g["opt_poses"]):
        assert np.abs(card[:, :2] - want[:, :2]).max() <= tol[0]
        assert np.abs(card[:, 2] - want[:, 2]).max() <= tol[1]


def test_loop_verification_on_the_card_equals_the_cpu(dev):
    """One verification chunk of the `slam` golden's graph nodes: the same
    pairs registered on the card (kernels A and F) and on the CPU (dense
    association, plain LM): poses within 1e-3 where both succeed, success
    flags and association counts equal in at least 95% of the lanes."""
    from cfear_radarodometry_code_public_tpu_torch.models import loopclosure
    cfg = chip_smoke.slam_config()
    rng = np.random.default_rng(0)
    k, m = 16, cfg.feature.max_cells
    base = rng.uniform(-60, 60, (1000, 2))
    scans = []
    for i in range(k):
        n = int(rng.integers(700, 1000))
        mean = (base[:n] + rng.normal(0, 0.05, (n, 2)) + i * 0.3
                ).astype(np.float32)
        nrm = rng.normal(size=(n, 2)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        scans.append({"cell_mean": mean, "cell_normal": nrm,
                      "cell_cov": np.tile(np.eye(2, dtype=np.float32) * 0.1,
                                          (n, 1, 1)),
                      "cell_nsamples": np.full(n, 8, np.float32),
                      "cell_planarity": np.ones(n, np.float32)})
    ii, jj = rng.integers(0, k, (2, 40))
    true = np.stack([(jj - ii) * 0.3, (jj - ii) * 0.3, 0 * ii], -1)
    guesses = (true + rng.normal(size=(40, 3)) * [0.3, 0.3, 0.02]
               ).astype(np.float32)
    out = []
    for d in (dev, torch.device("cpu")):
        closer = loopclosure.LoopCloser(cfg, device=d)
        stacked = loopclosure.stack_payloads(scans, m, d)
        ca.reset_launches()
        out.append(closer._verify(stacked, stacked, jj, ii, guesses))
        if d.type == "cuda":
            assert ca.launches["nn_min"] > 0
    card, cpu = out
    same = (card["success"] == cpu["success"]) & \
        (card["num_assoc"] == cpu["num_assoc"])
    assert same.mean() >= 0.95
    ok = same & card["success"]
    assert ok.sum() >= 20
    assert np.abs(card["pose"][ok] - cpu["pose"][ok]).max() <= 1e-3


def test_distributed_optimize_on_one_card_is_optimize(dev):
    """The edge-sharded optimizer on a NCCL group of one process (a local
    TCP rendezvous) equals `optimize` bit for bit on the `slam` golden's
    graph: the all-reduce of one rank is the identity."""
    import socket
    from cfear_radarodometry_code_public_tpu_torch.models import posegraph
    from cfear_radarodometry_code_public_tpu_torch.parallel import (
        distributed, mesh, pgo)
    with np.load(chip_smoke.GOLDEN_SLAM) as z:
        graph = chip_smoke.golden_graph({k: z[k] for k in z.files}, dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    distributed.initialize(coord, 1, 0, device=dev)
    try:
        m = mesh.make_mesh(device=dev)
        assert m.group is not None and torch.distributed.get_backend() == \
            "nccl"
        got, cost = pgo.distributed_optimize(graph, m, iters=6, cg_iters=60)
    finally:
        torch.distributed.destroy_process_group()
    want, cost_w = posegraph.optimize(graph, iters=6, cg_iters=60)
    assert torch.equal(got.poses, want.poses) and torch.equal(cost, cost_w)


def test_merge_sessions_on_the_card_launches_a_and_f(dev):
    """Two sessions of `tests/test_multisession.py`'s world (A 48 frames,
    B A's frames 16-44 with fresh speckle), odometry and graphs on the
    card, then `merge_sessions` on the card: the verification launches
    kernels A and F, and the merge agrees with the same graphs merged on
    the CPU (t_ab within 2e-3, poses within 1 cm and 2e-4 rad, the bound
    of tests/test_torch_multisession.py's MERGE_TOL)."""
    import dataclasses
    import cfear_radarodometry_code_public_tpu_torch as port
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    from cfear_radarodometry_code_public_tpu_torch.models import (
        multisession, odometry, posegraph)
    cfg = port.preset("CFEAR-3", dataset="synthetic")
    cfg = cfg.replace(
        feature=dataclasses.replace(cfg.feature, max_cells=256),
        filter=dataclasses.replace(cfg.filter, k_strongest=8))
    world = synthetic.make_world(np.random.default_rng(42))
    traj = synthetic.make_trajectory(np.random.default_rng(43), 48,
                                     dt=cfg.radar.sensor_period, speed=8.0)
    graphs = []
    for route, seed in ((traj, 100), (traj[16:44], 900)):
        images = []
        for i in range(len(route)):
            prev = route[i - 1] if i > 0 else route[i]
            c, s = np.cos(prev[2]), np.sin(prev[2])
            dx, dy = route[i, 0] - prev[0], route[i, 1] - prev[1]
            images.append(synthetic.render_polar(
                world, route[i], cfg, np.random.default_rng(seed + i),
                motion=np.array([c * dx + s * dy, -s * dx + c * dy,
                                 route[i, 2] - prev[2]])))
        images = np.stack(images)
        r = odometry.OdometryRunner(cfg, device=dev, chunk=8)
        r.process(images)
        graphs.append(posegraph.build_graph_from_odometry(
            r.frame_outputs(), r.trajectory(), images=images, cfg=cfg,
            device=dev))
    ca.reset_launches()
    cuda_lm.reset_launches()
    opt, _, inliers, t_ab = multisession.merge_sessions(*graphs, cfg,
                                                        device=dev)
    assert ca.launches["nn_min"] > 0 and cuda_lm.launches["lm_solve_fused"] > 0
    opt_c, _, inl_c, t_ab_c = multisession.merge_sessions(*graphs, cfg,
                                                          device="cpu")
    assert len(inliers) >= 2 and len(inl_c) >= 2
    assert np.abs(t_ab - t_ab_c).max() <= 2e-3
    assert np.abs(opt[:, :2] - opt_c[:, :2]).max() <= 1e-2
    assert np.abs(opt[:, 2] - opt_c[:, 2]).max() <= 2e-4


def _grid_near_ties(state, cfg):
    """(S, Msrc) bool, on the CPU: the slots of the association of a
    state's newest keyframe to its keyframes (as the grid test makes it)
    at a near-tie, where a device's rounding may pick either answer: the
    two nearest valid targets lie within 4 ulp of the source point's
    largest coordinate of each other in distance, or a coordinate of the
    source point lies within an ulp of a bucket edge."""
    from cfear_radarodometry_code_public_tpu_torch.ops import registration
    from cfear_radarodometry_code_public_tpu_torch.utils import se2
    kf = state.kf_cells
    t_rel = se2.relative(state.kf_poses[None], state.kf_poses[None, -1, None])
    src = se2.transform(t_rel, kf.mean[None, -1, None])[0]   # (S, Msrc, 2)
    d2 = ((src[:, :, None] - kf.mean[:, None]) ** 2).sum(-1)
    d2 = torch.where(kf.valid[:, None], d2, d2.new_full((), float("inf")))
    near = d2.topk(2, -1, largest=False).values.sqrt()
    ulp = torch.nextafter(src.abs().amax(-1), torch.tensor(float("inf"))) \
        - src.abs().amax(-1)
    tie = near[..., 1] - near[..., 0] <= 4 * ulp
    bin_size = registration._bucket_geometry(cfg)[0]
    u = src / bin_size
    edge = ((u - u.round()).abs() * bin_size
            <= torch.nextafter(src.abs(), torch.tensor(float("inf")))
            - src.abs()).any(-1)
    return tie | edge


def test_grid_association_on_the_card_equals_the_cpu(dev):
    """`assoc_method="grid"` runs on the card as torch ops (no kernel, as
    the reference runs it as XLA). The card's and the CPU's runs make the
    same keyframe decisions, and their trajectories lie within 1e-4 (kernel
    F against its twin in the LM; CUDA's sin/cos an ulp from the CPU's).
    Their keyframe states differ by that rounding (cell means ~7e-5 m), so
    their own associations may differ at near-ties (ROADMAP queue 3: three
    slots whose two nearest cells are duplicates, 2e-13 m^2 apart). On
    identical inputs, the CPU run's state on both devices, the bucket
    tables are identical, and so are the associations (tar_idx, valid,
    weight) on every slot but a near-tie (`_grid_near_ties`)."""
    import dataclasses
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    from cfear_radarodometry_code_public_tpu_torch.models import odometry
    from cfear_radarodometry_code_public_tpu_torch.ops import registration
    cfg = _small_cfg()
    cfg = cfg.replace(registration=dataclasses.replace(
        cfg.registration, assoc_method="grid"))
    images, _ = synthetic.make_sequence(seed=3, n_frames=6, cfg=cfg)
    runs = []
    for d in (dev, "cpu"):
        r = odometry.OdometryRunner(cfg, ingest="host", device=d, chunk=4)
        r.process(images)
        runs.append(r)
    card, cpu = runs
    assert np.array_equal(card.frame_outputs().fused, cpu.frame_outputs().fused)
    assert np.abs(card.trajectory() - cpu.trajectory()).max() < 1e-4
    st = cpu.state
    out = []
    for d in (dev, "cpu"):
        kf = odometry.CellMap(*(a[None].to(d) for a in st.kf_cells))
        src = odometry.CellMap(*(a[None, -1].to(d) for a in st.kf_cells))
        poses, kf_valid = st.kf_poses[None].to(d), st.kf_valid[None].to(d)
        a = registration.associate(kf, poses, kf_valid, src, poses[:, -1],
                                   2.0, cfg)
        out.append((registration.build_buckets(kf, cfg).cpu(),
                    [x[0].cpu() for x in a]))
    (tab_g, a_g), (tab_c, a_c) = out
    assert torch.equal(tab_g, tab_c)
    near = _grid_near_ties(st, cfg)
    assert (a_c[2] & ~near).sum() > 300       # held exactly: 433 of 596
    differ = (a_g[0] != a_c[0]) | (a_g[1] != a_c[1]) | (a_g[2] != a_c[2])
    assert near[differ].all(), differ.nonzero().tolist()


def test_grid_buckets_on_the_card_under_overflow(dev):
    """At Oxford width (3072 cells a keyframe, S=4) with buckets crowded
    past `bucket_capacity`: the card's tables equal the CPU's and, below
    the sink, `chip_smoke.grid_reference_table` (the reference's table in
    numpy), the sink -1, and two builds bit-identical: the rows scattered
    to the dump slot past the sink never leak into the kept table."""
    from cfear_radarodometry_code_public_tpu_torch.ops import registration
    cfg = chip_smoke.cli_path_config("cli-grid")
    bin_size, g = registration._bucket_geometry(cfg)
    rng = np.random.default_rng(5)
    s, m = 4, cfg.feature.max_cells
    mean = (rng.uniform(-0.45, 0.45, (s, m, 2)) * g * bin_size).astype(
        np.float32)
    mean[:, :500] = ((rng.uniform(0.1, 0.9, (s, 500, 2))
                      + rng.integers(0, 4, (s, 500, 1)) * 3)
                     * bin_size).astype(np.float32)
    valid = rng.random((s, m)) < 0.9
    z = torch.zeros((1, s, m))
    cells = features.CellMap(
        mean=torch.as_tensor(mean)[None], normal=torch.as_tensor(mean)[None],
        cov=torch.zeros((1, s, m, 2, 2)), nsamples=z, planarity=z,
        valid=torch.as_tensor(valid)[None])
    on_card = features.CellMap(*(a.to(dev) for a in cells))
    first = registration.build_buckets(on_card, cfg)
    again = registration.build_buckets(on_card, cfg)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(first.cpu(), registration.build_buckets(cells, cfg))
    got = first.cpu().numpy()[0]
    for k in range(s):
        want = chip_smoke.grid_reference_table(mean[k], valid[k], cfg)
        np.testing.assert_array_equal(got[k, :-1], want)
        assert got[k, -1] == -1 and (want >= 0).sum() < valid[k].sum()


def test_online_daemon_on_the_card_equals_the_offline_runner(dev, tmp_path):
    """The online daemon on the card over a finished pack (drain mode):
    one TUM line a frame, its trajectory bit for bit the card's offline
    runner's, kernels A and F launched."""
    from cfear_radarodometry_code_public_tpu_torch import online_odometry
    from cfear_radarodometry_code_public_tpu_torch.datasets import synthetic
    from cfear_radarodometry_code_public_tpu_torch.models import odometry
    from cfear_radarodometry_code_public_tpu_torch.utils import native_io
    cfg = _small_cfg()
    images, _ = synthetic.make_sequence(seed=4, n_frames=10, cfg=cfg)
    pack = str(tmp_path / "p.radarpack")
    native_io.pack_frames(pack, ((i * 0.25, images[i]) for i in range(10)),
                          10)
    ca.reset_launches()
    cuda_lm.reset_launches()
    daemon = online_odometry.OnlineOdometry(
        cfg, pack, str(tmp_path / "poses.tum"), chunk=4, ingest="host",
        device=dev)
    assert daemon.run(follow=False) == 10
    assert ca.launches["nn_min"] > 0 and cuda_lm.launches["lm_solve_fused"] > 0
    with open(tmp_path / "poses.tum") as f:
        assert len(f.read().splitlines()) == 10
    r = odometry.OdometryRunner(cfg, ingest="host", device=dev, chunk=4)
    r.process(images)
    assert np.array_equal(daemon.trajectory(), r.trajectory())
