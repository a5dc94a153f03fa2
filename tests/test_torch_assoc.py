"""Association kernels A (`nn_min`), B1 (`nn_min_multi`), B2
(`nn_min_multi_unrolled`), C (`nn_min_sparse`), D1
(`nn_min_sparse_multi`), D2 (`nn_min_sparse_unrolled`) and E
(`nn_min_sparse_attrs`): the port's plain twins against the reference's
Pallas kernels in interpret mode, on the cases of tests/test_registration.py
plus a tie case, with a lane axis. The CUDA kernels against the twins:
tests/test_torch_cuda.py.

Tolerance: nearest-neighbour indices are compared exactly. d2 is compared
bit for bit with the unfused f32 arithmetic (each of -, *, + rounded, the
TPU kernel's and the CUDA kernel's form), and to within 1 ulp of the
interpret-mode result: XLA's CPU backend contracts dx*dx + dy*dy into
fma(dx, dx, dy*dy), one rounding fewer."""

import math
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_cuda import dense_ties
from torch_port_helpers import jnp

from cfear_radarodometry_code_public_tpu.ops import pallas_assoc as pa
from cfear_radarodometry_code_public_tpu_torch.ops import cuda_assoc as ca

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

sys.path.remove(REPO)


def _dense_case(seed=3, s=3, m=512):
    """tests/test_registration.py:test_nn_kernel_variants_match's case:
    an exact duplicate target (a tie) and an empty keyframe."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(m, 2)).astype(np.float32) * 40
    tar = rng.normal(size=(s, m, 2)).astype(np.float32) * 40
    tar[1, 10] = tar[1, 20]
    src[5] = tar[1, 10]
    valid = rng.random((s, m)) < 0.8
    valid[2] = False
    return src, tar, valid


def _sparse_case(seed=1, s=4, m=1024, msrc=512):
    """tests/test_registration.py:test_sparse_assoc_kernel_matches_dense's
    case (spatially ordered points, an empty keyframe) plus a tie: two
    identical targets in different target tiles."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(msrc, 2)).astype(np.float32) * 60
    src = src[np.argsort(src[:, 0], kind="stable")]
    tar = rng.normal(size=(s, m, 2)).astype(np.float32) * 60
    for k in range(s):
        tar[k] = tar[k][np.argsort(tar[k][:, 0], kind="stable")]
    valid = rng.random((s, m)) < 0.8
    valid[2] = False
    valid[0, [300, 700]] = True
    tar[0, 700] = tar[0, 300]
    src[200] = tar[0, 300] + np.float32([0.25, 0.0])
    return src, tar, valid


def _t(*arrays):
    return [torch.as_tensor(np.array(a))[None] for a in arrays]


def _assert_d2(d2_port, d2_ref, nn, src, tar):
    """d2_port is the unfused f32 distance to target nn, bit for bit, and
    within 1 ulp of the reference's d2."""
    t = np.take_along_axis(tar, nn[..., None].astype(np.int64), axis=1)
    dx, dy = src[None, :, 0] - t[..., 0], src[None, :, 1] - t[..., 1]
    unfused = dx * dx + dy * dy
    fin = np.isfinite(d2_ref)
    np.testing.assert_array_equal(d2_port[fin], unfused[fin])
    np.testing.assert_array_equal(np.isfinite(d2_port), fin)
    np.testing.assert_array_max_ulp(d2_port[fin], d2_ref[fin], maxulp=1)


def test_nn_min_plain_matches_pallas():
    src, tar, valid = _dense_case()
    nn_r, d2_r = pa.nn_min(jnp.asarray(src), jnp.asarray(tar),
                           jnp.asarray(valid), interpret=True, ts=256)
    nn_t, d2_t = ca.nn_min(*_t(src, tar, valid))
    np.testing.assert_array_equal(nn_t[0].numpy(), np.asarray(nn_r))
    _assert_d2(d2_t[0].numpy(), np.asarray(d2_r), np.asarray(nn_r), src, tar)
    assert nn_t[0, 1, 5] == 10                     # lowest index wins the tie
    assert np.isinf(d2_t[0, 2].numpy()).all() and (nn_t[0, 2] == 0).all()


@pytest.mark.parametrize("radius", [2.0, 5.0])
def test_nn_min_sparse_plain_matches_pallas(radius):
    src, tar, valid = _sparse_case()
    jsrc, jtar, jvalid = map(jnp.asarray, (src, tar, valid))
    sb = pa.tile_bounds(jsrc, jnp.ones(len(src), bool), 256)
    tb = pa.tile_bounds(jtar, jvalid, pa._TT_SPARSE)
    nn_r, d2_r = pa.nn_min_sparse(jsrc, sb, jtar, tb, jvalid, radius,
                                  interpret=True, ts=256)
    tsrc, ttar, tvalid = _t(src, tar, valid)
    sb_t = ca.tile_bounds(tsrc, torch.ones(1, len(src), dtype=torch.bool), 256)
    tb_t = ca.tile_bounds(ttar, tvalid, ca.TT_SPARSE)
    np.testing.assert_array_equal(sb_t[0].numpy(), np.asarray(sb))
    np.testing.assert_array_equal(tb_t[0].numpy(), np.asarray(tb))
    nn_t, d2_t = ca.nn_min_sparse(tsrc, sb_t, ttar, tb_t, tvalid,
                                  torch.tensor([radius]))
    np.testing.assert_array_equal(nn_t[0].numpy(), np.asarray(nn_r))
    _assert_d2(d2_t[0].numpy(), np.asarray(d2_r), np.asarray(nn_r), src, tar)
    # within the radius the sparse twin equals the dense twin
    nn_d, d2_d = ca.nn_min(tsrc, ttar, tvalid)
    within = d2_d[0] <= radius * radius
    assert within.any() and not within.all()
    assert torch.equal(nn_t[0][within], nn_d[0][within])
    assert torch.equal(d2_t[0][within], d2_d[0][within])
    assert (d2_t[0][~within] >= radius * radius).all()
    assert nn_t[0, 0, 200] == 300                 # tie across target tiles


def test_plain_twins_batch_over_lanes():
    """A (B=2) call equals the two single-lane calls."""
    src, tar, valid = _sparse_case()
    src2, tar2, valid2 = _sparse_case(seed=2)
    b_src, b_tar, b_valid = (torch.as_tensor(np.stack([a, c]))
                             for a, c in ((src, src2), (tar, tar2),
                                          (valid, valid2)))
    sb = ca.tile_bounds(b_src, torch.ones(2, len(src), dtype=torch.bool), 256)
    tb = ca.tile_bounds(b_tar, b_valid, ca.TT_SPARSE)
    radius = torch.tensor([4.0, 2.0])
    nn_b, d2_b = ca.nn_min_sparse(b_src, sb, b_tar, tb, b_valid, radius)
    nd_b, dd_b = ca.nn_min(b_src, b_tar, b_valid)
    for i in range(2):
        nn_1, d2_1 = ca.nn_min_sparse(b_src[i:i + 1], sb[i:i + 1],
                                      b_tar[i:i + 1], tb[i:i + 1],
                                      b_valid[i:i + 1], radius[i:i + 1])
        nd_1, dd_1 = ca.nn_min(b_src[i:i + 1], b_tar[i:i + 1],
                               b_valid[i:i + 1])
        assert torch.equal(nn_b[i], nn_1[0]) and torch.equal(d2_b[i], d2_1[0])
        assert torch.equal(nd_b[i], nd_1[0]) and torch.equal(dd_b[i], dd_1[0])


def test_wrappers_check_their_inputs():
    src, tar, valid = _t(*_dense_case())
    with pytest.raises(TypeError, match="float32"):
        ca.nn_min(src.double(), tar, valid)
    with pytest.raises(ValueError, match="contiguous"):
        ca.nn_min(src, tar.transpose(1, 2), valid)
    with pytest.raises(ValueError, match="must both be 0"):
        ca.nn_min_sparse(src[:, :500], torch.zeros(1, 1, 4), tar,
                         torch.zeros(1, 3, 1, 4), valid, torch.ones(1))
    assert ca.supported(1024) and not ca.supported(1000)
    assert ca.supported_sparse(1024, 1024) and not ca.supported_sparse(256, 768)


def test_cpu_calls_count_no_launches():
    ca.reset_launches()
    ca.nn_min(*_t(*_dense_case()))
    src, tar, valid = _sparse_case(s=3)
    lanes = _lanes([(src, tar, valid)], 4.0)
    ca.nn_min_sparse(*lanes)
    ca.nn_min_sparse_multi(*lanes)
    ca.nn_min_sparse_unrolled(*lanes)
    ca.nn_min_sparse_attrs(*lanes[:5], torch.zeros(1, 3, 8, 1024), lanes[5])
    src, tar, valid = _t(*_dense_case(s=4))
    ca.nn_min_multi(src, tar, valid)
    ca.nn_min_multi_unrolled(src, tar, valid)
    assert set(ca.launches) == {"nn_min", "nn_min_multi",
                                "nn_min_multi_unrolled", "nn_min_sparse",
                                "nn_min_sparse_multi",
                                "nn_min_sparse_unrolled",
                                "nn_min_sparse_attrs"}
    assert not any(ca.launches.values())


def _lanes(cases, radius):
    """Per-lane (src, tar, valid) numpy cases -> the sparse kernels'
    arguments with a lane axis: src, src_bounds, tar, tar_bounds, valid,
    radius (B,)."""
    src, tar, valid = (torch.as_tensor(np.stack(a)) for a in zip(*cases))
    sb = ca.tile_bounds(src, torch.ones(src.shape[:2], dtype=torch.bool),
                        ca.TS_SPARSE)
    tb = ca.tile_bounds(tar, valid, ca.TT_SPARSE)
    return src, sb, tar, tb, valid, torch.full((len(cases),), radius)


def _ref_sparse(fn, case, radius, *extra):
    """A reference block-sparse kernel on one lane, in interpret mode."""
    src, tar, valid = map(jnp.asarray, case)
    sb = pa.tile_bounds(src, jnp.ones(src.shape[0], bool), 256)
    tb = pa.tile_bounds(tar, valid, pa._TT_SPARSE)
    extra = [jnp.asarray(a) for a in extra]
    return [np.asarray(a) for a in fn(src, sb, tar, tb, valid, *extra, radius,
                                      interpret=True, ts=256)]


@pytest.mark.parametrize("name,seed", [("multi", 9), ("unrolled", 13)])
def test_multi_keyframe_twins_match_pallas(name, seed):
    """D1 and D2 (tests/test_registration.py:608-658: S=6, M=1024,
    Msrc=512, radius 5) over B=2 lanes: an empty keyframe in each lane and
    an exact tie across target tiles. nn equal to the reference kernel;
    d2 within 1 ulp; both equal to C's twin."""
    radius = 5.0
    cases = [_sparse_case(seed=seed + i, s=6) for i in range(2)]
    port_fn = getattr(ca, f"nn_min_sparse_{name}")
    ref_fn = getattr(pa, f"nn_min_sparse_{name}")
    args = _lanes(cases, radius)
    nn_t, d2_t = port_fn(*args)
    nn_c, d2_c = ca.nn_min_sparse(*args)
    assert torch.equal(nn_t, nn_c) and torch.equal(d2_t, d2_c)
    for i, (src, tar, valid) in enumerate(cases):
        nn_r, d2_r = _ref_sparse(ref_fn, cases[i], radius)
        np.testing.assert_array_equal(nn_t[i].numpy(), nn_r)
        _assert_d2(d2_t[i].numpy(), d2_r, nn_r, src, tar)
        assert np.isinf(d2_t[i, 2].numpy()).all()          # empty keyframe
        assert nn_t[i, 0, 200] == 300                       # the tie


def _attrs_case(rng, s, m, d, d_pad):
    """Random attribute rows (S, M, D) with zero entries (a zero column and
    scattered zeros) and their transposed, padded (S, D_pad, M) form."""
    attrs = rng.normal(size=(s, m, d)).astype(np.float32)
    attrs[..., 3] = 0.0
    attrs[rng.random((s, m, d)) < 0.1] = 0.0
    at = np.zeros((s, d_pad, m), np.float32)
    at[:, :d] = np.swapaxes(attrs, -1, -2)
    return attrs, at


def test_attrs_twin_matches_pallas():
    """E (tests/test_registration.py:570-605: S=4, M=1024, Msrc=512, radius
    5, D=7, D_pad 8) over B=2 lanes with an empty keyframe, a tie and
    attribute rows that carry zeros: (nn, d2) as C's twin and the reference
    kernel (d2 within 1 ulp); g bit-equal to the reference's within the
    radius, and zero on +inf rows."""
    radius, s, d, d_pad = 5.0, 4, 7, 8
    rng = np.random.default_rng(5)
    cases = [_sparse_case(seed=5 + i, s=s) for i in range(2)]
    ats = [_attrs_case(rng, s, 1024, d, d_pad) for _ in cases]
    args = _lanes(cases, radius)
    at_t = torch.as_tensor(np.stack([a[1] for a in ats]))
    nn_t, d2_t, g_t = ca.nn_min_sparse_attrs(*args[:5], at_t, args[5])
    nn_c, d2_c = ca.nn_min_sparse(*args)
    assert torch.equal(nn_t, nn_c) and torch.equal(d2_t, d2_c)
    assert g_t.shape == (2, s, d_pad, 512)
    for i, (src, tar, valid) in enumerate(cases):
        nn_r, d2_r, g_r = _ref_sparse(pa.nn_min_sparse_attrs, cases[i],
                                      radius, ats[i][1])
        np.testing.assert_array_equal(nn_t[i].numpy(), nn_r)
        _assert_d2(d2_t[i].numpy(), d2_r, nn_r, src, tar)
        g = np.swapaxes(g_t[i].numpy(), -1, -2)            # (S, Msrc, D_pad)
        within = d2_t[i].numpy() <= radius * radius
        assert within.any() and (g[within] == 0).any()
        np.testing.assert_array_equal(g[within],
                                      np.swapaxes(g_r, -1, -2)[within])
        np.testing.assert_array_equal(
            g[within][:, :d],
            np.take_along_axis(ats[i][0], nn_r[..., None], axis=1)[within])
        inf = np.isinf(d2_t[i].numpy())
        assert inf.any() and (g[inf] == 0).all()


def test_unrolled_rejects_other_budgets():
    src, tar, valid = _sparse_case(s=3)
    tar = np.concatenate([tar, tar[:, :512]], 1)            # M = 1536
    valid = np.concatenate([valid, valid[:, :512]], 1)
    args = _lanes([(src, tar, valid)], 4.0)
    assert ca.supported_sparse(512, 1536)
    ca.nn_min_sparse_multi(*args)                           # D1 takes any M
    with pytest.raises(ValueError, match="512, 1024, 2048, 3072"):
        ca.nn_min_sparse_unrolled(*args)
    with pytest.raises(ValueError, match="D_pad"):
        ca.nn_min_sparse_attrs(*args[:5], torch.zeros(1, 3, 7, 1536), args[5])


def _split_model(src, sb, tar, tb, valid, radius, split):
    """Kernel C's split (csrc/nn_assoc.cu `nn_min_sparse_split_kernel`)
    in the twin's arithmetic: rank c of `split` takes target tiles [c nt /
    split, (c+1) nt / split); each slice of SPLIT_SLICE targets of a live
    tile is scanned in groups of SPLIT_GROUP, a row's best moving to a
    group's minimum only on a strict '<'; the winning group is rescanned
    for the first target at that distance; slices, then ranks, are merged
    by lexicographic (d2, index). Invalid targets are (+inf, +inf)."""
    b, s, m = valid.shape
    m_src, nt = src.shape[1], m // ca.TT_SPARSE
    inf = torch.tensor(float("inf"))
    t = torch.where(valid[..., None], tar, inf)
    dx = src[:, None, :, None, 0] - t[:, :, None, :, 0]
    dy = src[:, None, :, None, 1] - t[:, :, None, :, 1]
    d2 = dx * dx + dy * dy
    live = ca.pair_live(sb, tb, radius).repeat_interleave(ca.TS_SPARSE, 2)
    g = ca.SPLIT_GROUP
    n_slice, n_grp = ca.TT_SPARSE // ca.SPLIT_SLICE, ca.SPLIT_SLICE // g
    out_d = torch.full((b, s, m_src), float("inf"))
    out_i = torch.zeros((b, s, m_src), dtype=torch.int64)
    for c in range(split):
        t0, t1 = c * nt // split, (c + 1) * nt // split
        for q in range(n_slice):
            # (B, S, Msrc, tiles, groups, G): the slice's targets of each tile
            d = d2[..., t0 * ca.TT_SPARSE:t1 * ca.TT_SPARSE].reshape(
                b, s, m_src, t1 - t0, n_slice, n_grp, g)[..., q, :, :]
            gm = torch.where(torch.isnan(d), inf, d).amin(-1)   # fminf
            gm = torch.where(live[..., t0:t1, None], gm, inf).flatten(-2)
            best, grp = gm.amin(-1), gm.argmin(-1)   # first group at the min
            tile, k = grp // n_grp, grp % n_grp
            first = (d.flatten(-3, -2).gather(
                -2, grp[..., None, None].expand(*grp.shape, 1, g))[..., 0, :]
                == best[..., None]).to(torch.int8).argmax(-1)
            idx = ((t0 + tile) * ca.TT_SPARSE + q * ca.SPLIT_SLICE + k * g
                   + first)
            idx = torch.where(torch.isinf(best), 0, idx)
            take = (best < out_d) | ((best == out_d) & (idx < out_i))
            out_d = torch.where(take, best, out_d)
            out_i = torch.where(take, idx, out_i)
    return out_i.to(torch.int32), out_d


@pytest.mark.parametrize("split", [1, 2, 4])
def test_split_merge_equals_twin_and_pallas(split):
    """Kernel C's split, modelled on the CPU (`_split_model`), equals
    `nn_min_sparse_plain` and the reference kernel in interpret mode at
    each cluster size the shape allows (S=4, Msrc=512, M=2048: four target
    tiles; `sparse_split` takes 4), with exact ties across a group, a slice, a tile and each rank
    boundary, an empty keyframe and Msrc != M."""
    radius = 5.0
    src, tar, valid = _sparse_case(seed=17, m=2048)
    ties = ((0, 15, 16, 40), (0, 127, 128, 41), (1, 511, 512, 42),
            (1, 1023, 1024, 43), (3, 1535, 1536, 44), (0, 300, 1700, 45))
    for k, lo, hi, row in ties:
        tar[k, hi] = tar[k, lo]
        valid[k, [lo, hi]] = True
        src[row] = tar[k, lo]
    args = _lanes([(src, tar, valid)], radius)
    nn_m, d2_m = _split_model(*args, split)
    nn_p, d2_p = ca.nn_min_sparse_plain(*args)
    assert torch.equal(nn_m, nn_p) and torch.equal(d2_m, d2_p)
    for k, lo, _, row in ties:
        if k != 2:
            assert nn_m[0, k, row] == lo and d2_m[0, k, row] == 0
    assert torch.isinf(d2_m[0, 2]).all() and (nn_m[0, 2] == 0).all()
    nn_r, d2_r = _ref_sparse(pa.nn_min_sparse, (src, tar, valid), radius)
    np.testing.assert_array_equal(nn_m[0].numpy(), nn_r)
    _assert_d2(d2_m[0].numpy(), d2_r, nn_r, src, tar)


@pytest.mark.parametrize("radius", [2.0, 4.0])
def test_split_model_on_smoke_inputs(radius):
    """`chip_smoke.c_inputs` (Morton-ordered wall cells, the inputs the
    card check uses) on the CPU, cut to B=2, S=3, Msrc=512, M=1024: kernel
    C's split at the cluster size the shape gets and at 1 equals the twin;
    the tie across target tiles goes to the lower index, the last lane's
    last keyframe is empty."""
    args = chip_smoke.c_inputs(torch.device("cpu"), 2, 3, 512, 1024, radius)
    nn_p, d2_p = ca.nn_min_sparse_plain(*args)
    assert ca.sparse_split(2, 3, 512, 1024) == 2
    for split in (1, 2):
        nn_m, d2_m = _split_model(*args, split)
        assert torch.equal(nn_m, nn_p) and torch.equal(d2_m, d2_p)
    assert nn_p[0, 0, 5] == 300 and d2_p[0, 0, 5] == 0
    assert torch.isinf(d2_p[1, 2]).all() and (nn_p[1, 2] == 0).all()
    assert torch.isfinite(d2_p).float().mean() > 0.5


def test_sparse_split_follows_the_shape():
    """Kernel C's cluster size from the shape: grown to SPLIT_MIN_CTAS
    CTAs, never past the target tiles or 8, 0 (the one-block form) where 8
    CTAs cannot hold a keyframe's tiles; the kernel's limits hold."""
    want = {(1, 4, 1024, 1024): 2, (8, 4, 1024, 1024): 1,
            (1, 50, 1024, 1024): 1, (8, 50, 1024, 1024): 1,
            (1, 50, 3072, 3072): 1, (8, 4, 512, 1024): 2,
            (1, 1, 256, 4096): 8, (1, 1, 256, 512): 1,
            (1, 1, 256, 8 * ca.SPLIT_MAX_TILES * 512): 8,
            (1, 1, 256, (8 * ca.SPLIT_MAX_TILES + 1) * 512): 0}
    for shape, c in want.items():
        assert ca.sparse_split(*shape) == c, shape
        nt = shape[3] // ca.TT_SPARSE
        if c:
            assert c <= max(nt, 1) and -(-nt // c) <= ca.SPLIT_MAX_TILES
    assert ca.TT_SPARSE % ca.SPLIT_SLICE == 0
    assert ca.SPLIT_SLICE % ca.SPLIT_GROUP == 0


def _dense_model(src, tar, valid, split):
    """Kernel A (csrc/nn_assoc.cu `nn_min_dense_kernel`) in the twin's
    arithmetic: a keyframe's targets cut into chunks of DENSE_CHUNK, the
    tail padded with (+inf, +inf) as invalid targets are; rank c of
    `split` takes chunks [c nc / split, (c+1) nc / split) and stages them
    DENSE_STAGE targets a pass; each slice of DENSE_SLICE targets of a
    chunk is scanned in groups of DENSE_GROUP, a row's minimum over a group
    by fminf (NaN dropped), its best moving to a group's minimum only on a
    strict '<'; the winning group is rescanned, in the pass where the best
    moved, for the first target at that distance; slices, then ranks, are
    merged by lexicographic (d2, index)."""
    b, s, m = valid.shape
    m_src = src.shape[1]
    ch, sl, g = ca.DENSE_CHUNK, ca.DENSE_SLICE, ca.DENSE_GROUP
    nc, n_slice, n_grp = -(-m // ch), ch // sl, sl // g
    inf = torch.tensor(float("inf"))
    t = torch.where(valid[..., None], tar, inf)
    t = torch.cat([t, t.new_full((b, s, nc * ch - m, 2), float("inf"))], 2)
    dx = src[:, None, :, None, 0] - t[:, :, None, :, 0]
    dy = src[:, None, :, None, 1] - t[:, :, None, :, 1]
    d2 = dx * dx + dy * dy                               # (B, S, Msrc, nc*ch)

    def lex(d, i, e, j):
        take = (e < d) | ((e == d) & (j < i))
        return torch.where(take, e, d), torch.where(take, j, i)

    out_d = torch.full((b, s, m_src), float("inf"))
    out_i = torch.zeros((b, s, m_src), dtype=torch.int64)
    for c in range(split):
        lo, hi = c * nc // split * ch, (c + 1) * nc // split * ch
        rank_d, rank_i = out_d.new_full(out_d.shape, float("inf")), \
            torch.zeros_like(out_i)
        for q in range(n_slice):
            best = out_d.new_full(out_d.shape, float("inf"))
            bi = torch.zeros_like(out_i)
            for base in range(lo, hi, ca.DENSE_STAGE):
                n = min(ca.DENSE_STAGE, hi - base)
                # (B, S, Msrc, groups, G): the slice's groups of the pass
                d = d2[..., base:base + n].reshape(
                    b, s, m_src, n // ch, n_slice, n_grp, g)[..., q, :, :]
                d = d.flatten(-3, -2)
                gm = torch.where(torch.isnan(d), inf, d).amin(-1)  # fminf
                pm, grp = gm.amin(-1), gm.argmin(-1)   # first group at the min
                moved = pm < best
                first = (d.gather(-2, grp[..., None, None].expand(
                    *grp.shape, 1, g))[..., 0, :] == pm[..., None]).to(
                        torch.int8).argmax(-1)
                idx = (base + grp // n_grp * ch + q * sl + grp % n_grp * g
                       + first)
                best = torch.where(moved, pm, best)
                bi = torch.where(moved, idx, bi)
            rank_d, rank_i = lex(rank_d, rank_i, best, bi)
        out_d, out_i = lex(out_d, out_i, rank_d, rank_i)
    return out_i.to(torch.int32), out_d


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_dense_model_equals_twin_and_pallas(split):
    """Kernel A's split, modelled on the CPU (`_dense_model`), equals
    `nn_min_plain` and the reference kernel in interpret mode at each
    cluster size `dense_split` can pick (S=4, Msrc=512, M=4096: 16 chunks,
    two staging passes at split 1), with exact ties across a group, a
    slice, a chunk, each rank boundary and the pass boundary, and an empty
    keyframe."""
    (src, tar, valid), ties = dense_ties()
    args = [torch.as_tensor(a) for a in (src, tar, valid)]
    nn_m, d2_m = _dense_model(*args, split)
    nn_p, d2_p = ca.nn_min_plain(*args)
    assert torch.equal(nn_m, nn_p) and torch.equal(d2_m, d2_p)
    for k, lo, row in ties:
        assert nn_m[0, k, row] == lo and d2_m[0, k, row] == 0
    assert torch.isinf(d2_m[0, 3]).all() and (nn_m[0, 3] == 0).all()
    nn_r, d2_r = (np.asarray(a) for a in pa.nn_min(
        jnp.asarray(src[0]), jnp.asarray(tar[0]), jnp.asarray(valid[0]),
        interpret=True))
    np.testing.assert_array_equal(nn_m[0].numpy(), nn_r)
    _assert_d2(d2_m[0].numpy(), d2_r, nn_r, src[0], tar[0])


@pytest.mark.parametrize("split", [1, 2, 4])
def test_dense_model_takes_ragged_sizes(split):
    """Msrc=1000, M=1500 (six chunks, the last padded; `dense_split` takes
    4): the model equals the twin over B=2 lanes and the reference kernel
    on the source padded to its tile (its rows are independent), with a
    tie in the padded chunk."""
    (src, tar, valid), ties = dense_ties(seed=29, b=2, s=3, m_src=1000,
                                         m=1500)
    tar[:, 0, 1499] = tar[:, 0, 1300]
    valid[:, 0, [1300, 1499]] = True
    src[:, 30] = tar[:, 0, 1300]
    args = [torch.as_tensor(a) for a in (src, tar, valid)]
    assert ca.dense_split(2, 3, 1000, 1500) == 4
    nn_m, d2_m = _dense_model(*args, split)
    nn_p, d2_p = ca.nn_min_plain(*args)
    assert torch.equal(nn_m, nn_p) and torch.equal(d2_m, d2_p)
    assert (nn_m[:, 0, 30] == 1300).all() and (d2_m[:, 0, 30] == 0).all()
    for k, lo, row in ties:
        assert (nn_m[:, k, row] == lo).all()
    pad = np.zeros((1024, 2), np.float32)
    pad[:1000] = src[1]
    nn_r, d2_r = (np.asarray(a)[:, :1000] for a in pa.nn_min(
        jnp.asarray(pad), jnp.asarray(tar[1]), jnp.asarray(valid[1]),
        interpret=True))
    np.testing.assert_array_equal(nn_m[1].numpy(), nn_r)
    _assert_d2(d2_m[1].numpy(), d2_r, nn_r, src[1], tar[1])


def test_dense_model_on_smoke_inputs():
    """`chip_smoke.a_inputs` (Morton-ordered wall cells, the inputs the
    card check uses) on the CPU, cut to B=2, S=4, Msrc=M=1024: kernel A's
    split at the cluster size the shape gets and at 1 equals the twin; the
    tie across chunks goes to the lower index, the last lane's last
    keyframe is empty."""
    args = chip_smoke.a_inputs(torch.device("cpu"), 2, 4, 1024, 1024)
    nn_p, d2_p = ca.nn_min_plain(*args)
    assert ca.dense_split(2, 4, 1024, 1024) == 4
    for split in (1, 4):
        nn_m, d2_m = _dense_model(*args, split)
        assert torch.equal(nn_m, nn_p) and torch.equal(d2_m, d2_p)
    assert nn_p[0, 0, 5] == 300 and d2_p[0, 0, 5] == 0
    assert torch.isinf(d2_p[1, 3]).all() and (nn_p[1, 3] == 0).all()
    assert torch.isfinite(d2_p).float().mean() > 0.7


def test_dense_split_follows_the_shape():
    """Kernel A's cluster size from the shape, at every shape of
    `chip_smoke.A_SHAPES` and at the limits: grown to DENSE_MIN_CTAS CTAs,
    never past the target chunks or 8; any M takes a split."""
    want = {(8, 4, 1024, 1024): 2, (1, 4, 2048, 2048): 8,
            (8, 4, 2048, 2048): 1, (1, 1, 2048, 2048): 8,
            (27, 4, 2048, 2048): 1, (512, 1, 1024, 1024): 1,
            (256, 1, 1024, 1024): 1, (1, 4, 3072, 3072): 8,
            (3, 2, 1000, 1500): 4,
            (1, 1, 256, 256): 1, (1, 1, 256, 257): 2, (1, 1, 256, 100): 1,
            (1, 1, 1, 10 ** 6): 8, (64, 1, 2048, 10 ** 6): 1}
    assert set(chip_smoke.A_SHAPES) <= set(want)
    for shape, c in want.items():
        assert ca.dense_split(*shape) == c, shape
        chunks = -(-shape[3] // ca.DENSE_CHUNK)
        assert c in (1, 2, 4, 8) and (c == 1 or c <= chunks)
    assert ca.DENSE_CHUNK % ca.DENSE_SLICE == 0
    assert ca.DENSE_SLICE % ca.DENSE_GROUP == 0
    assert ca.DENSE_STAGE % ca.DENSE_CHUNK == 0
    assert ca.DENSE_TILE % ca.DENSE_ROWS == 0


def test_dense_nonfinite_source_rows():
    """Source rows at NaN and +-inf (ROADMAP queue 3): kernel A, as its
    model shows, reports (+inf, 0) for each, as its first form and B1/B2
    do; the twin reports NaN at the first valid target for a NaN row, the
    reference kernel NaN at index 0; all three agree on the +-inf rows.
    No answer passes the association gate d2 < r^2."""
    src = torch.tensor([[[np.nan, 0.0], [np.inf, 0.0], [-np.inf, np.inf],
                         [1.0, 1.0]]])
    tar = torch.tensor([[[[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]]])
    valid = torch.tensor([[[False, True, True]]])
    nn_m, d2_m = _dense_model(src, tar, valid, 1)
    assert nn_m.tolist() == [[[0, 0, 0, 1]]]
    assert d2_m[0, 0, :3].isinf().all() and d2_m[0, 0, 3] == 0
    nn_p, d2_p = ca.nn_min_plain(src, tar, valid)
    assert nn_p.tolist() == [[[1, 0, 0, 1]]] and d2_p[0, 0, 0].isnan()
    assert torch.equal(d2_p[0, 0, 1:], d2_m[0, 0, 1:])
    pad = np.zeros((256, 2), np.float32)
    pad[:4] = src[0].numpy()
    nn_r, d2_r = (np.asarray(a)[0, :4] for a in pa.nn_min(
        jnp.asarray(pad), jnp.asarray(np.pad(tar[0].numpy(),
                                             ((0, 0), (0, 253), (0, 0)))),
        jnp.asarray(np.pad(valid[0].numpy(), ((0, 0), (0, 253)))),
        interpret=True))
    assert nn_r.tolist() == [0, 0, 0, 1] and np.isnan(d2_r[0])
    for d2 in (d2_m[0, 0, :3], d2_p[0, 0, :3], torch.tensor(d2_r[:3])):
        assert not (d2 < 4.0).any()


@pytest.mark.parametrize("cost", ["P2P", "P2D"])
def test_attrs_twin_matches_gather_inside_gate(cost):
    """E's twin gives the rows `_associate_world` gathers with
    `_gather_attrs`, on every association its gate accepts, for the
    world attributes of real cells (D=7 -> D_pad 8 for P2P, D=10 -> 16 for
    P2D)."""
    from test_torch_registration import _lane, _problem
    from torch_port_helpers import both_cfgs
    from cfear_radarodometry_code_public_tpu_torch.ops import registration as treg
    from cfear_radarodometry_code_public_tpu_torch.utils import se2
    cfg, kf_cells, kf_poses, src, guess = _problem(cost, "pallas_sparse",
                                                   n_kf=4)
    cfg_t = both_cfgs(cfg)[1]
    kf_t, src_t = _lane(kf_cells), _lane(src)
    poses = torch.as_tensor(kf_poses)[None]
    kf_valid = torch.tensor([[True, True, False, True]])
    pose = torch.as_tensor(guess)[None]
    radius = torch.tensor([2.0 * cfg.registration.assoc_radius])
    attrs = treg._world_attrs(kf_t, poses, cfg_t)
    assoc, _ = treg._associate_world(
        attrs, src_t, pose, kf_valid, radius, cfg_t,
        math.cos(math.radians(cfg.registration.angle_outlier_deg)),
        "pallas_sparse")
    b, s, m, d = attrs.shape
    d_pad = 8 if d <= 8 else 16
    assert d == (10 if cost == "P2D" else 7)
    at = torch.zeros(b, s, d_pad, m)
    at[:, :, :d] = attrs.transpose(-1, -2)
    src_w = se2.transform(pose, src_t.mean).contiguous()
    tar_xy = attrs[..., 0:2].contiguous()
    tar_valid = (attrs[..., 6] > 0.5) & kf_valid[..., None]
    nn, d2, g = ca.nn_min_sparse_attrs(
        src_w, ca.tile_bounds(src_w, src_t.valid, ca.TS_SPARSE).contiguous(),
        tar_xy, ca.tile_bounds(tar_xy, tar_valid, ca.TT_SPARSE).contiguous(),
        tar_valid, at, radius)
    assert torch.equal(nn, assoc.tar_idx)
    ok = assoc.valid
    assert ok.sum() > 100
    gathered = treg._gather_attrs(attrs, nn)
    assert torch.equal(g.transpose(-1, -2)[..., :d][ok], gathered[ok])
    assert (g.transpose(-1, -2)[..., d:] == 0).all()


@pytest.mark.parametrize("s,m", [(1, 1024), (4, 1024), (4, 2560)])
def test_dense_multi_keyframe_twins_match_pallas(s, m):
    """B1 and B2 over B=2 lanes against the reference's `nn_min_multi` and
    `nn_min_multi_unrolled` in interpret mode: S=1 (the health check's
    reverse problem) and S=4 (CFEAR-3's window, an empty keyframe), both
    source tiles (512 rows up to M=2048, 256 above), a tie. nn equal, d2
    within 1 ulp, both equal to A's twin."""
    msrc = 512
    cases = []
    for i in range(2):
        src, tar, valid = _dense_case(seed=21 + i, s=max(s, 3), m=m)
        tar, valid = tar[:s].copy(), valid[:s].copy()
        tar[0, 20] = tar[0, 10]                 # a tie in keyframe 0
        valid[0, [10, 20]] = True
        src[5] = tar[0, 10]
        cases.append((src[:msrc], tar, valid))
    src, tar, valid = (torch.as_tensor(np.stack(a)) for a in zip(*cases))
    nn_a, d2_a = ca.nn_min(src, tar, valid)
    for name in ("nn_min_multi", "nn_min_multi_unrolled"):
        nn_t, d2_t = getattr(ca, name)(src, tar, valid)
        assert torch.equal(nn_t, nn_a) and torch.equal(d2_t, d2_a), name
        for i, (c_src, c_tar, c_valid) in enumerate(cases):
            nn_r, d2_r = (np.asarray(a) for a in getattr(pa, name)(
                jnp.asarray(c_src), jnp.asarray(c_tar), jnp.asarray(c_valid),
                interpret=True))
            np.testing.assert_array_equal(nn_t[i].numpy(), nn_r)
            _assert_d2(d2_t[i].numpy(), d2_r, nn_r, c_src, c_tar)
    assert (nn_a[:, 0, 5] == 10).all()           # lowest index wins the tie
    if s == 4:
        assert np.isinf(d2_a[:, 2].numpy()).all() and (nn_a[:, 2] == 0).all()


def test_dense_multi_keyframe_wrappers_refuse_what_the_reference_refuses():
    src, tar, valid = _t(*_dense_case(s=4))                 # M = 512
    with pytest.raises(ValueError):                         # the reference
        pa.nn_min_multi(jnp.asarray(src[0, :256]), jnp.asarray(tar[0]),
                        jnp.asarray(valid[0]), interpret=True)
    for fn in (ca.nn_min_multi, ca.nn_min_multi_unrolled):
        with pytest.raises(ValueError, match="% 512"):
            fn(src[:, :256].contiguous(), tar, valid)
        with pytest.raises(ValueError, match="% 128"):      # supported_multi
            fn(src, tar[:, :, :500].contiguous(),
               valid[:, :, :500].contiguous())
    assert ca.supported_multi(512, 2048) and ca.supported_multi(256, 2560)
    assert not ca.supported_multi(256, 2048)
    assert not ca.supported_multi(512, 1000)
    assert pa.supported_multi(512, 2048) and not pa.supported_multi(512, 1000)
    with pytest.raises(ValueError, match=r"\(1, 4\)"):
        ca.nn_min_multi_unrolled(src[:, :, :0], tar[:, :2].contiguous(),
                                 valid[:, :2].contiguous())
    ca.nn_min_multi(src, tar[:, :2].contiguous(), valid[:, :2].contiguous())
