"""Exact 1-NN association: CUDA kernels and their plain PyTorch twins
(port of `ops/pallas_assoc.py`: kernels A `nn_min`, B1 `nn_min_multi`, B2
`nn_min_multi_unrolled`, C `nn_min_sparse`, D1 `nn_min_sparse_multi`, D2
`nn_min_sparse_unrolled` and E `nn_min_sparse_attrs`).

Every function takes the reference's layout with a leading lane axis, so one
launch serves a batched step: src (B, Msrc, 2), tar (B, S, M, 2),
valid (B, S, M) -> nn (B, S, Msrc) int32, d2 (B, S, Msrc) float32.
B1 and B2 compute A's function (a CTA walks a group of a lane's keyframes
with A's scan, S read at runtime or known at compile time) and share A's
twin; D1 and D2 compute C's function (a CTA
walks a group of a lane's keyframes, M read at runtime or known at compile
time) and share C's twin; E adds the winner's attribute column,
attrs_t (B, S, D_pad, M) -> g (B, S, D_pad, Msrc).

Dispatch: each wrapper runs its plain twin only when the tensors lie on the
CPU. For CUDA tensors it launches its kernel of `csrc/nn_assoc.cu` or
raises; there is no fallback. The kernels and the twins agree bit for bit
(same difference form, no FMA contraction, lowest-index argmin on ties).

`launches` counts kernel launches per kernel (CPU calls add nothing);
`reset_launches()` zeroes it.
"""

from __future__ import annotations

import torch

TS_SPARSE = 256      # source rows per skip-test granule (kernels C, D1, D2, E)
TT_SPARSE = 512      # target rows per skip-test granule
_TS = 256            # cell-budget granule of the dense kernel's policy
# target budgets kernel D2 has a static instance for: the one list, which
# `_build` passes to nvcc as the template instances (M / TT_SPARSE tiles
# each, at most 30); any other M runs the runtime-count instance
UNROLLED_M = (512, 1024, 2048, 3072)
# keyframe counts kernel B2 has a static instance for, the one list
# (`_build` passes it to nvcc): 1 is the health check's reverse problem, 4
# CFEAR-3's window; any other S runs the runtime-count instance
UNROLLED_S = (1, 4)
# Kernel C's split (`_build` passes these to nvcc): each 512-row target
# tile is scanned in slices of SPLIT_SLICE targets by slices of threads, a
# row's minimum is taken over groups of SPLIT_GROUP targets before its best
# moves, and one CTA stages at most SPLIT_MAX_TILES target tiles. The
# cluster grows until it gives SPLIT_MIN_CTAS CTAs, about one for each of
# an H100's 132 SMs: past that a cluster's barriers and each CTA's own
# staging cost more than the SMs it adds give back.
SPLIT_SLICE, SPLIT_GROUP, SPLIT_MAX_TILES, SPLIT_MIN_CTAS = 128, 16, 8, 128
# Kernel A (`_build` passes all but the last to nvcc): a CTA takes a tile of
# DENSE_TILE source rows, DENSE_ROWS a thread; a keyframe's targets are cut
# into chunks of DENSE_CHUNK, padded at the end, which a cluster's ranks
# share; each chunk is scanned in slices of DENSE_SLICE targets by slices
# of threads, a row's minimum taken over groups of DENSE_GROUP targets
# before its best moves; a CTA stages its chunks DENSE_STAGE targets at a
# time. The cluster grows until it gives DENSE_MIN_CTAS CTAs, about two for
# each of an H100's 132 SMs: the fastest size at every shape of
# chip_smoke.A_SHAPES but B=8 S=4 M=1024, where one CTA a keyframe is 3%
# faster (tools/compare_torch_kernels.py --mode a-sweep).
DENSE_TILE, DENSE_ROWS, DENSE_CHUNK, DENSE_SLICE = 256, 4, 256, 64
DENSE_GROUP, DENSE_STAGE, DENSE_MIN_CTAS = 16, 2048, 256
# Kernels D1 and D2 scan as kernel C does (SPLIT_SLICE, SPLIT_GROUP; a
# stage of their ring holds at most SPLIT_MAX_TILES target tiles) and cut a
# lane's keyframes into groups until the grid has WALK_MIN_CTAS CTAs, about
# six for each of an H100's 132 SMs: two waves of the three CTAs D1's 77
# registers let an SM hold, so no SM is left with a group more than the
# rest. Two an SM (256) left SMs with two groups of 7 keyframes, 14 against
# a mean of 12.1 an SM, at B=8, S=50 and ran 19% slower than 800 (two
# keyframes a CTA); C's grid, one keyframe a CTA, was the fastest at every
# shape of chip_smoke.C_SHAPES, 800 within 2-5% of it at B=8, S=50 and the
# same elsewhere (tools/compare_torch_kernels.py --mode d-sweep).
WALK_MIN_CTAS = 800
# Kernels B1 and B2 scan as kernel A does (the DENSE_ constants), cut a
# lane's keyframes into groups as D1 and D2 do (`walk_groups`), and, where
# one keyframe a CTA still leaves the grid short, share each keyframe's
# chunks over a cluster until the grid has MULTI_MIN_CTAS CTAs, about one
# for each of an H100's 132 SMs, as kernel C does. At every shape of
# chip_smoke.A_SHAPES and the long-run window (tools/compare_torch_kernels.py
# --mode b-sweep): one keyframe a CTA was the fastest (two a CTA 15% slower
# at B=27, S=4); of the cluster sizes, 128 CTAs was the fastest or within
# 3% of it but at B=1, S=4, M=2048 (9% for B1, 2% for B2), where 64 to 256
# CTAs lie within 9% of each other; A's 256 cost 30-42% at B=1, S=4,
# M=3072 and 28-35% at the window's B=8, S=1.
MULTI_MIN_CTAS = 128

launches = {"nn_min": 0, "nn_min_multi": 0, "nn_min_multi_unrolled": 0,
            "nn_min_sparse": 0, "nn_min_sparse_multi": 0,
            "nn_min_sparse_unrolled": 0, "nn_min_sparse_attrs": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supported(m: int) -> bool:
    """Same policy as the reference: the cell budget tiles evenly."""
    return m % _TS == 0


def ts_multi(m: int) -> int:
    """The reference's `_ts_multi`, its B1/B2 source tile: 512 rows up to
    M = 2048, else 256. The port keeps it for the reference's refusal
    (Msrc % ts_multi(M), which B1 and B2 share); its kernels take any
    Msrc."""
    return 512 if m <= 2048 else 256


def supported_multi(m_src: int, m_tar: int) -> bool:
    """The reference's `supported_multi`: the source tiles evenly and the
    target budget is a multiple of 128. Its B1 and B2 refuse only the
    first (`m_src % ts_multi(m_tar)`), and so do the port's."""
    return m_src % ts_multi(m_tar) == 0 and m_tar % 128 == 0


def supported_sparse(m_src: int, m_tar: int) -> bool:
    return m_src % TS_SPARSE == 0 and m_tar % TT_SPARSE == 0


def sparse_split(b: int, s: int, m_src: int, m: int) -> int:
    """CTAs per (lane x keyframe, source tile) of kernel C, from the shape
    alone: the smallest power of two up to 8 and up to the M / 512 target
    tiles that gives SPLIT_MIN_CTAS CTAs in all and at most SPLIT_MAX_TILES
    tiles a CTA; 0, the one-block-per-tile-pair kernel, where no cluster of
    8 keeps a CTA's tiles within that limit. Any split gives the same bits:
    the partial minima are merged by lexicographic (d2, index). Kernel E,
    C's split kernel with a column copy after the merge, takes the same
    split."""
    nt = m // TT_SPARSE
    pairs = b * s * (m_src // TS_SPARSE)
    c = 1
    while c < 8 and 2 * c <= nt and (pairs * c < SPLIT_MIN_CTAS
                                     or -(-nt // c) > SPLIT_MAX_TILES):
        c *= 2
    return c if -(-nt // c) <= SPLIT_MAX_TILES else 0


def walk_groups(b: int, s: int, m_src: int, m: int) -> int:
    """Keyframe groups per (lane, source tile) of kernels D1 and D2, from
    the shape alone: the smallest count up to S that gives WALK_MIN_CTAS
    CTAs in all (M does not enter: a CTA stages any number of target tiles
    in passes). Group g takes keyframes [g S / G, (g + 1) S / G), so every
    keyframe falls in exactly one; any count gives the same bits, since
    each keyframe's output is its own."""
    pairs = b * (m_src // TS_SPARSE)
    return max(1, min(s, -(-WALK_MIN_CTAS // max(pairs, 1))))


def multi_split(b: int, s: int, m_src: int, m: int) -> tuple:
    """(keyframe groups, cluster size) per (lane, source tile) of kernels
    B1 and B2, from the shape alone: the groups of `walk_groups`; where
    those are S (one keyframe a CTA), the smallest power of two up to 8 and
    up to the keyframe's ceil(M / DENSE_CHUNK) chunks that gives
    MULTI_MIN_CTAS CTAs, and else 1. Group g takes keyframes [g S / G, (g +
    1) S / G), so every keyframe falls in exactly one; any count and size
    give the same bits, since each keyframe's output is its own and the
    partial minima are merged by lexicographic (d2, index)."""
    groups = walk_groups(b, s, m_src, m)
    if groups < s:
        return groups, 1
    pairs = b * s * -(-m_src // DENSE_TILE)
    chunks = -(-m // DENSE_CHUNK)
    c = 1
    while c < 8 and 2 * c <= chunks and pairs * c < MULTI_MIN_CTAS:
        c *= 2
    return groups, c


def dense_split(b: int, s: int, m_src: int, m: int) -> int:
    """CTAs per (lane x keyframe, source tile) of kernel A, from the shape
    alone: the smallest power of two up to 8 and up to the keyframe's
    ceil(M / DENSE_CHUNK) target chunks that gives DENSE_MIN_CTAS CTAs in
    all. Any M runs (a CTA stages its chunks DENSE_STAGE targets at a
    time), and any split gives the same bits: the partial minima are
    merged by lexicographic (d2, index)."""
    chunks = -(-m // DENSE_CHUNK)
    pairs = b * s * -(-m_src // DENSE_TILE)
    c = 1
    while c < 8 and 2 * c <= chunks and pairs * c < DENSE_MIN_CTAS:
        c *= 2
    return c


def tile_bounds(xy, valid, tile: int):
    """Per-contiguous-tile bounding boxes [xmin, xmax, ymin, ymax]:
    xy (..., N, 2), valid (..., N) -> (..., N/tile, 4); empty tiles get
    (+inf, -inf, +inf, -inf) so every pair test skips them."""
    shape = xy.shape[:-2] + (xy.shape[-2] // tile, tile)
    inf = xy.new_full((), float("inf"))
    x = torch.where(valid, xy[..., 0], inf).reshape(shape)
    y = torch.where(valid, xy[..., 1], inf).reshape(shape)
    xn = torch.where(valid, xy[..., 0], -inf).reshape(shape)
    yn = torch.where(valid, xy[..., 1], -inf).reshape(shape)
    return torch.stack([x.amin(-1), xn.amax(-1), y.amin(-1), yn.amax(-1)], -1)


def _d2_dense(src, tar, valid):
    """(B, S, Msrc, M) squared distances in the difference form, each
    operation rounded on its own, +inf at invalid targets."""
    dx = src[:, None, :, None, 0] - tar[:, :, None, :, 0]
    dy = src[:, None, :, None, 1] - tar[:, :, None, :, 1]
    d2 = dx * dx + dy * dy
    return torch.where(valid[:, :, None, :], d2, d2.new_full((), float("inf")))


def nn_min_plain(src, tar, valid):
    """Plain twin of kernel A: exact 1-NN per keyframe, lowest index on
    ties, (+inf, 0) where a keyframe has no valid target."""
    d2 = _d2_dense(src, tar, valid)
    return torch.argmin(d2, dim=-1).to(torch.int32), d2.amin(-1)


def pair_live(src_bounds, tar_bounds, radius):
    """(B, S, Msrc/TS, M/TT) bool: the tile pair's bbox gap is within the
    radius (the kernels' per-block skip test, in the same f32 arithmetic).
    Its mean is the executed share of tile pairs."""
    sb = src_bounds[:, None, :, None, :]                 # (B, 1, ns, 1, 4)
    tb = tar_bounds[:, :, None, :, :]                    # (B, S, 1, nt, 4)
    zero = sb.new_zeros(())
    gapx = torch.maximum(torch.maximum(tb[..., 0] - sb[..., 1],
                                       sb[..., 0] - tb[..., 1]), zero)
    gapy = torch.maximum(torch.maximum(tb[..., 2] - sb[..., 3],
                                       sb[..., 2] - tb[..., 3]), zero)
    r2 = radius * radius
    return gapx * gapx + gapy * gapy <= r2[:, None, None, None]


def nn_min_sparse_plain(src, src_bounds, tar, tar_bounds, valid, radius):
    """Plain twin of kernels C, D1 and D2: kernel A restricted to tile pairs
    that pass the bbox gap test; rows with no unskipped valid target report
    (+inf, 0). Equal to A on every row whose true 1-NN is within the
    radius; other rows report d2 >= radius^2."""
    live = pair_live(src_bounds, tar_bounds, radius)
    live = live.repeat_interleave(TS_SPARSE, 2).repeat_interleave(TT_SPARSE, 3)
    d2 = torch.where(live, _d2_dense(src, tar, valid),
                     src.new_full((), float("inf")))
    return torch.argmin(d2, dim=-1).to(torch.int32), d2.amin(-1)


def nn_min_sparse_attrs_plain(src, src_bounds, tar, tar_bounds, valid,
                              attrs_t, radius):
    """Plain twin of kernel E: C's twin, then the winner's attribute column
    g[..., :, n] = attrs_t[..., :, nn[n]] wherever d2 is finite, zeros
    where it is +inf."""
    nn, d2 = nn_min_sparse_plain(src, src_bounds, tar, tar_bounds, valid,
                                 radius)
    idx = nn.to(torch.int64)[:, :, None, :].expand(-1, -1, attrs_t.shape[2],
                                                   -1)
    g = torch.gather(attrs_t, 3, idx)
    return nn, d2, torch.where(torch.isfinite(d2)[:, :, None, :], g,
                               g.new_zeros(()))


def _check(name, **tensors):
    dev = None
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {k} is on {t.device}, expected {dev}")
        want = torch.bool if k == "valid" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {k} must be {want}, got {t.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    return dev


def _check_shapes(name, src, tar, valid):
    if src.dim() != 3 or src.shape[-1] != 2:
        raise ValueError(f"{name}: src must be (B, Msrc, 2), got {tuple(src.shape)}")
    b, s, m = valid.shape
    if tar.shape != (b, s, m, 2) or src.shape[0] != b:
        raise ValueError(f"{name}: shapes src {tuple(src.shape)}, tar "
                         f"{tuple(tar.shape)}, valid {tuple(valid.shape)} "
                         "do not match (B, Msrc, 2), (B, S, M, 2), (B, S, M)")


def _check_sparse(name, src, src_bounds, tar, tar_bounds, valid, radius,
                  **extra):
    """The checks kernels C, D1, D2 and E share; returns the device."""
    dev = _check(name, src=src, src_bounds=src_bounds, tar=tar,
                 tar_bounds=tar_bounds, valid=valid, radius=radius, **extra)
    _check_shapes(name, src, tar, valid)
    b, s, m = valid.shape
    m_src = src.shape[1]
    if not supported_sparse(m_src, m):
        raise ValueError(
            f"{name}: m_src={m_src} % {TS_SPARSE} and m_tar={m} % "
            f"{TT_SPARSE} must both be 0")
    if (src_bounds.shape != (b, m_src // TS_SPARSE, 4)
            or tar_bounds.shape != (b, s, m // TT_SPARSE, 4)
            or radius.shape != (b,)):
        raise ValueError(f"{name}: bounds or radius shape mismatch")
    return dev


def _launch(name, entry, dev, *args):
    """Call the library's `entry` with `args` and the current stream; raise
    on a CUDA error, else count one launch of `name`."""
    from cfear_radarodometry_code_public_tpu_torch.ops import _build
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_build.library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    launches[name] += 1


def _nn_out(valid, m_src, dev):
    b, s, _ = valid.shape
    return (torch.empty((b, s, m_src), dtype=torch.int32, device=dev),
            torch.empty((b, s, m_src), dtype=torch.float32, device=dev))


def _check_aligned(name, src, tar, valid=None):
    """src and tar start on 8-byte boundaries (the kernels read points as
    float2); with `valid`, for kernels B1, B2, D1 and D2, which copy
    targets 16 bytes and valid bytes 4 at a time, tar on 16 and valid on
    4."""
    if (src.data_ptr() | tar.data_ptr()) % 8:
        raise ValueError(f"{name}: src and tar must start on 8-byte "
                         "boundaries (the kernel reads points as float2)")
    if valid is not None and (tar.data_ptr() % 16 or valid.data_ptr() % 4):
        raise ValueError(f"{name}: tar must start on a 16-byte and valid on "
                         "a 4-byte boundary (the kernel copies them 16 and 4 "
                         "bytes at a time)")


def nn_min(src, tar, valid):
    """Exact 1-NN of each source point among each keyframe's targets
    (kernel A on CUDA, split over `dense_split` CTAs per keyframe and
    source tile; `nn_min_plain` on the CPU). Any Msrc and M."""
    dev = _check("nn_min", src=src, tar=tar, valid=valid)
    _check_shapes("nn_min", src, tar, valid)
    if dev.type == "cpu":
        return nn_min_plain(src, tar, valid)
    _check_aligned("nn_min", src, tar)
    b, s, m = valid.shape
    m_src = src.shape[1]
    nn, d2 = _nn_out(valid, m_src, dev)
    if nn.numel():
        _launch("nn_min", "cfear_nn_min", dev, src.data_ptr(), tar.data_ptr(),
                valid.data_ptr(), b, s, m_src, m,
                dense_split(b, s, m_src, m), nn.data_ptr(), d2.data_ptr())
    return nn, d2


def _multi(name, entry, src, tar, valid):
    """Refuse what the reference's B1 and B2 refuse (Msrc % ts_multi(M)),
    then run `nn_min_plain` on the CPU or launch `entry` on CUDA."""
    dev = _check(name, src=src, tar=tar, valid=valid)
    _check_shapes(name, src, tar, valid)
    b, s, m = valid.shape
    m_src = src.shape[1]
    if m_src % ts_multi(m):
        raise ValueError(f"{name}: m_src={m_src} % {ts_multi(m)} must be 0")
    if dev.type == "cpu":
        return nn_min_plain(src, tar, valid)
    _check_aligned(name, src, tar, valid)
    nn, d2 = _nn_out(valid, m_src, dev)
    if nn.numel():
        _launch(name, entry, dev, src.data_ptr(), tar.data_ptr(),
                valid.data_ptr(), b, s, m_src, m,
                *multi_split(b, s, m_src, m), nn.data_ptr(), d2.data_ptr())
    return nn, d2


def nn_min_multi(src, tar, valid):
    """`nn_min` with the keyframe loop inside the kernel (kernel B1 on
    CUDA: one CTA per (lane, group of keyframes, source tile, cluster rank)
    from `multi_split` walks its keyframes with kernel A's scan;
    `nn_min_plain` on the CPU). Identical outputs; any S and M. Shapes the
    reference refuses (Msrc % ts_multi(M)) raise ValueError."""
    return _multi("nn_min_multi", "cfear_nn_min_multi", src, tar, valid)


def nn_min_multi_unrolled(src, tar, valid):
    """`nn_min_multi` with the keyframe loop unrolled at compile time
    (kernel B2 on CUDA: the static instance for S in `UNROLLED_S`, the
    runtime-count instance for any other S, the same bits, counted as B2's
    launch; `nn_min_plain` on the CPU). Identical outputs. The shapes
    `nn_min_multi` refuses raise ValueError."""
    return _multi("nn_min_multi_unrolled", "cfear_nn_min_multi_unrolled",
                  src, tar, valid)


def _sparse(name, entry, src, src_bounds, tar, tar_bounds, valid, radius,
            *extra):
    """Launch one of C, D1, D2 (same arguments, same outputs; `extra` ints
    follow M: C's split, D1's and D2's keyframe groups)."""
    b, s, m = valid.shape
    nn, d2 = _nn_out(valid, src.shape[1], src.device)
    if nn.numel():
        _launch(name, entry, src.device, src.data_ptr(), src_bounds.data_ptr(),
                tar.data_ptr(), tar_bounds.data_ptr(), valid.data_ptr(),
                radius.data_ptr(), b, s, src.shape[1], m, *extra,
                nn.data_ptr(), d2.data_ptr())
    return nn, d2


def nn_min_sparse(src, src_bounds, tar, tar_bounds, valid, radius):
    """Block-sparse exact 1-NN within `radius` (B,) per keyframe (kernel C
    on CUDA, split over `sparse_split` CTAs per keyframe and source tile;
    `nn_min_sparse_plain` on the CPU). src_bounds (B, Msrc/256, 4),
    tar_bounds (B, S, M/512, 4) from `tile_bounds`."""
    args = (src, src_bounds, tar, tar_bounds, valid, radius)
    if _check_sparse("nn_min_sparse", *args).type == "cpu":
        return nn_min_sparse_plain(*args)
    _check_aligned("nn_min_sparse", src, tar)
    return _sparse("nn_min_sparse", "cfear_nn_min_sparse", *args,
                   sparse_split(*valid.shape[:2], src.shape[1],
                                valid.shape[2]))


def _walk(name, entry, src, src_bounds, tar, tar_bounds, valid, radius):
    """Launch D1 or D2 over `walk_groups` keyframe groups."""
    _check_aligned(name, src, tar, valid)
    return _sparse(name, entry, src, src_bounds, tar, tar_bounds, valid,
                   radius, walk_groups(*valid.shape[:2], src.shape[1],
                                       valid.shape[2]))


def nn_min_sparse_multi(src, src_bounds, tar, tar_bounds, valid, radius):
    """`nn_min_sparse` with the keyframe loop inside the kernel (kernel D1
    on CUDA: one CTA per (lane, group of `walk_groups` keyframes, 256-row
    source tile) walks its keyframes in turn; `nn_min_sparse_plain` on the
    CPU). Identical outputs; any M % 512 == 0."""
    args = (src, src_bounds, tar, tar_bounds, valid, radius)
    if _check_sparse("nn_min_sparse_multi", *args).type == "cpu":
        return nn_min_sparse_plain(*args)
    return _walk("nn_min_sparse_multi", "cfear_nn_min_sparse_multi", *args)


def nn_min_sparse_unrolled(src, src_bounds, tar, tar_bounds, valid, radius):
    """`nn_min_sparse_multi` with M known at compile time (kernel D2 on
    CUDA: the static instance for M in `UNROLLED_M`, the runtime-count
    instance for any other M, the same bits, counted as D2's launch;
    `nn_min_sparse_plain` on the CPU). Identical outputs; any M % 512 ==
    0, as the reference's D2."""
    args = (src, src_bounds, tar, tar_bounds, valid, radius)
    if _check_sparse("nn_min_sparse_unrolled", *args).type == "cpu":
        return nn_min_sparse_plain(*args)
    return _walk("nn_min_sparse_unrolled", "cfear_nn_min_sparse_unrolled",
                 *args)


def nn_min_sparse_attrs(src, src_bounds, tar, tar_bounds, valid, attrs_t,
                        radius):
    """`nn_min_sparse` plus the winner's attribute column (kernel E on CUDA:
    kernel C's split kernel, over the same `sparse_split` CTAs per keyframe
    and source tile, with the column copied by the thread that writes a
    row; `nn_min_sparse_attrs_plain` on the CPU). attrs_t (B, S, D_pad, M) is
    the transposed world-attribute matrix, D_pad a multiple of 8. Returns
    (nn, d2, g (B, S, D_pad, Msrc)) with g[..., :, n] = attrs_t[..., :,
    nn[n]] where d2 is finite and zeros where it is +inf."""
    dev = _check_sparse("nn_min_sparse_attrs", src, src_bounds, tar,
                        tar_bounds, valid, radius, attrs_t=attrs_t)
    b, s, m = valid.shape
    if attrs_t.dim() != 4 or attrs_t.shape[:2] != (b, s) \
            or attrs_t.shape[3] != m:
        raise ValueError(f"nn_min_sparse_attrs: attrs_t must be ({b}, {s}, "
                         f"D_pad, {m}), got {tuple(attrs_t.shape)}")
    d_pad = attrs_t.shape[2]
    if d_pad == 0 or d_pad % 8:
        raise ValueError(f"nn_min_sparse_attrs: D_pad={d_pad} must be a "
                         "positive multiple of 8")
    if dev.type == "cpu":
        return nn_min_sparse_attrs_plain(src, src_bounds, tar, tar_bounds,
                                         valid, attrs_t, radius)
    _check_aligned("nn_min_sparse_attrs", src, tar)
    m_src = src.shape[1]
    nn, d2 = _nn_out(valid, m_src, dev)
    g = torch.empty((b, s, d_pad, m_src), dtype=torch.float32, device=dev)
    if nn.numel():
        _launch("nn_min_sparse_attrs", "cfear_nn_min_sparse_attrs", dev,
                src.data_ptr(), src_bounds.data_ptr(), tar.data_ptr(),
                tar_bounds.data_ptr(), valid.data_ptr(), attrs_t.data_ptr(),
                radius.data_ptr(), b, s, m_src, m, d_pad,
                sparse_split(b, s, m_src, m), nn.data_ptr(), d2.data_ptr(),
                g.data_ptr())
    return nn, d2, g
