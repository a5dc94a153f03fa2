"""Oriented surface points ("cells") (port of `ops/features.py`).

Three dense passes over a static per-lane voxel grid, batched over lanes:

1. scatter-add points into the grid -> per-voxel unweighted centroid;
2. for each of the 9 neighbour offsets, test every point against the
   neighbour voxel's centroid (exact circular radius test) and scatter-add
   its weighted moments into its OWN voxel, then roll each offset's grid
   onto the target voxel and shift the moment origin in closed form;
3. closed-form 2x2 eigendecomposition, the validity gates of
   `pointnormal.cpp:53-56`, and compaction to `max_cells`.

With `feature.backend="pallas"`, stage 2 instead ranks the occupied voxels
(compact cells) and hands each point's neighbour ranks to kernel G
(`cuda_features.moment_accumulate`), which sums the moments per compact
cell; "auto" stays the scatter form, as in the reference.

`jax.ops.segment_sum` becomes `segment_sum`: `index_add_` with torch's
deterministic mode switched on around it, so that on CUDA it sums each
segment in a fixed order instead of with float atomics, and a run repeats
bit for bit. Both ranking sorts are stable, as `jnp.argsort` is.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from cfear_radarodometry_code_public_tpu_torch.ops import cuda_features
from cfear_radarodometry_code_public_tpu_torch.ops.filtering import PointCloud
from cfear_radarodometry_code_public_tpu_torch.utils import se2


class CellMap(NamedTuple):
    """Fixed-size masked set of oriented surface points."""

    mean: torch.Tensor        # (..., M, 2) float32 — weighted mean, local frame
    normal: torch.Tensor      # (..., M, 2) float32 — unit normal (toward sensor)
    cov: torch.Tensor         # (..., M, 2, 2) float32
    nsamples: torch.Tensor    # (..., M) float32 — points inside the search radius
    planarity: torch.Tensor   # (..., M) float32 — log(1 + cond/2)
    valid: torch.Tensor       # (..., M) bool

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic mode for the enclosed ops only; the caller's
    setting (and its warn-only flag) is restored afterwards."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def segment_sum(data, ids, n: int):
    """Rows of `data` (K, ...) summed by segment id `ids` (K,) int64 into
    (n, ...), in a fixed order on every device (`jax.ops.segment_sum`)."""
    out = data.new_zeros((n,) + tuple(data.shape[1:]))
    with _deterministic():
        out.index_add_(0, ids, data)
    return out


def _grid_geometry(cfg):
    """Static voxel-grid geometry: (leaf, dim, noff)."""
    leaf = cfg.feature.res / cfg.feature.downsample_factor
    half = int(math.ceil(cfg.radar.max_usable_range / leaf)) + 2
    dim = 2 * half
    if dim > (1 << 15):
        raise ValueError(
            f"voxel grid dim {dim} exceeds the 15-bit Morton-code limit "
            f"(max_usable_range={cfg.radar.max_usable_range}, leaf={leaf}); "
            "increase feature.res or reduce radar.max_usable_range")
    noff = int(math.ceil(cfg.feature.res / leaf))
    return leaf, dim, noff


def _eig2x2_min(a, b, c):
    """Eigen-pair of symmetric [[a, b], [b, c]]: (lmin, lmax, evec_min)."""
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp(0.25 * (a - c) ** 2 + b * b, min=0.0))
    lmin = half_tr - disc
    lmax = half_tr + disc
    v1 = torch.stack([lmin - c, b], -1)
    v2 = torch.stack([b, lmin - a], -1)
    n1 = (v1 * v1).sum(-1)
    n2 = (v2 * v2).sum(-1)
    v = torch.where((n1 >= n2)[..., None], v1, v2)
    vn = (v * v).sum(-1, keepdim=True)
    # degenerate (isotropic) covariance: fall back to the x-axis
    v = torch.where(vn > 1e-20, v * torch.rsqrt(torch.clamp(vn, min=1e-20)),
                    torch.stack([torch.ones_like(a), torch.zeros_like(a)], -1))
    return lmin, lmax, v


def _morton2(ix, iy):
    """Interleave two <=15-bit non-negative int32 coordinates (Z order)."""
    def spread(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v
    return spread(ix) | (spread(iy) << 1)


def budget_points(points: PointCloud, budget: int) -> PointCloud:
    """Row compaction to a fixed point budget (leaves (B, N, ...)): keep the
    `budget` strongest valid points, in (intensity desc, index asc) order —
    the contract the native host compaction reproduces."""
    key = torch.where(points.valid, points.intensity,
                      points.intensity.new_full((), -1.0))
    order = torch.argsort(-key, dim=-1, stable=True)[..., :budget]
    return PointCloud(
        xy=torch.gather(points.xy, -2, order[..., None].expand(
            order.shape + (2,))),
        intensity=torch.gather(points.intensity, -1, order),
        valid=torch.gather(points.valid, -1, order),
        peak=torch.gather(points.peak, -1, order))


def compute_cells(points: PointCloud, cfg) -> CellMap:
    """Point cloud (N, ...) -> oriented surface points (one scan)."""
    batched = compute_cells_batched(
        PointCloud(*(a[None] for a in points)), cfg)
    return CellMap(*(a[0] for a in batched))


def compute_cells_batched(points: PointCloud, cfg) -> CellMap:
    """Batched oriented-surface-point extraction: leaves carry (B, N, ...).
    All lanes share one scatter per stage (segment ids offset by
    lane * ncells). `feature.backend="pallas"` takes kernel G
    (`_compute_cells_batched_pallas`); "auto" is the scatter form here, as
    in the reference (`features.py:155-165`)."""
    feat = cfg.feature
    p = feat.point_budget
    if p and p < points.xy.shape[1]:
        points = budget_points(points, p)
    if feat.backend == "pallas":
        return _compute_cells_batched_pallas(points, cfg)

    leaf, dim, noff = _grid_geometry(cfg)
    ncells = dim * dim
    xy = points.xy                                            # (B, N, 2)
    b, n_pts = xy.shape[0], xy.shape[1]
    dev, f32 = xy.device, xy.dtype

    # --- stage 1: voxel centroids (unweighted, like pcl::VoxelGrid) ---
    vidx, in_grid, vid, vid_flat, centroid, occupied = _voxel_centroids(
        xy, points.valid, leaf, dim)

    # --- stage 2: weighted moments per candidate cell ---
    w_pt = _point_weights(points, feat)
    offsets = _neighbour_offsets(noff)
    n_off = len(offsets)
    nb_pt = _neighbourhood(
        torch.cat([centroid.reshape(b, dim, dim, 2),
                   occupied.reshape(b, dim, dim, 1).to(f32)], -1),
        vid, in_grid, offsets)                                # (B, N, 3 n_off)

    # moments about the OWN voxel centre, shifted to the target centre later
    own_cx, own_cy = _own_centres(vidx, leaf, dim)
    rx = xy[..., 0] - own_cx
    ry = xy[..., 1] - own_cy
    base = torch.stack(
        [torch.ones_like(w_pt), w_pt, w_pt * rx, w_pt * ry,
         w_pt * rx * rx, w_pt * rx * ry, w_pt * ry * ry], -1)  # (B, N, 7)

    mem_cols = []
    for oi, (dx, dy) in enumerate(offsets):
        mem_cols.append(_member(xy, vidx, in_grid, nb_pt[..., 3 * oi:3 * oi + 3],
                                dx, dy, dim, feat.res))
    mem = torch.stack(mem_cols, -1).to(f32)                   # (B, N, n_off)

    data = (mem[..., :, None] * base[..., None, :]).reshape(b * n_pts, n_off * 7)
    acc_own = segment_sum(data, vid_flat, b * ncells + 1)[:b * ncells].reshape(
        b, dim, dim, n_off, 7)

    acc = torch.zeros((b, dim, dim, 7), dtype=f32, device=dev)
    for oi, (dx, dy) in enumerate(offsets):
        g = torch.roll(acc_own[..., oi, :], (dx, dy), (1, 2))
        dxl, dyl = dx * leaf, dy * leaf
        cnt, s0_, s1x, s1y, sxx, sxy, syy = g.unbind(-1)
        acc = acc + torch.stack(
            [cnt, s0_,
             s1x - dxl * s0_,
             s1y - dyl * s0_,
             sxx - 2.0 * dxl * s1x + dxl * dxl * s0_,
             sxy - dxl * s1y - dyl * s1x + dxl * dyl * s0_,
             syy - 2.0 * dyl * s1y + dyl * dyl * s0_], -1)
    acc = acc.reshape(b, ncells, 7).unbind(-1)

    ii = torch.arange(dim, dtype=f32, device=dev) - dim // 2 + 0.5
    vc_x = ii.repeat_interleave(dim) * leaf                   # (ncells,)
    vc_y = ii.repeat(dim) * leaf

    # --- stage 3: normals + validity gates ---
    mean, nvec, cxx, cxy, cyy, planarity, gate = _normals_and_gates(
        *acc, vc_x, vc_y, feat)
    ib = torch.arange(ncells, dtype=torch.int64, device=dev)[None].expand(b, -1)
    return _finalize_cells(mean, nvec, cxx, cxy, cyy, acc[0], planarity,
                           occupied & gate, ib // dim, ib % dim, cfg)


def _voxel_centroids(xy, valid, leaf, dim):
    """Stage 1 of both backends: per point its voxel index (B, N, 2), the
    in-grid mask and flat voxel id (B, N), its lane-offset segment id
    (B*N,) with one overflow slot at B*ncells; per voxel the unweighted
    centroid (B, ncells, 2) and occupancy (B, ncells)."""
    b, n_pts = xy.shape[0], xy.shape[1]
    ncells = dim * dim
    dev, f32 = xy.device, xy.dtype
    lane = torch.arange(b, dtype=torch.int64, device=dev)[:, None]
    # divide by a device tensor: a Python divisor makes CUDA multiply by its
    # f32 reciprocal, which moves boundary points to the neighbour voxel
    vidx = torch.floor(xy / torch.full((), leaf, dtype=f32, device=dev)
                       ).to(torch.int64) + dim // 2
    in_grid = valid & ((vidx >= 0) & (vidx < dim)).all(-1)
    vid = vidx[..., 0] * dim + vidx[..., 1]                   # (B, N)
    vid_flat = torch.where(in_grid, lane * ncells + vid,
                           torch.full_like(vid, b * ncells)).reshape(-1)
    ones = in_grid.to(f32)
    s1 = segment_sum(torch.cat([ones[..., None], xy * ones[..., None]], -1
                               ).reshape(b * n_pts, 3), vid_flat,
                     b * ncells + 1)[:b * ncells].reshape(b, ncells, 3)
    cnt_vox, sum_vox = s1[..., 0], s1[..., 1:3]
    centroid = sum_vox / torch.clamp(cnt_vox, min=1.0)[..., None]
    return vidx, in_grid, vid, vid_flat, centroid, cnt_vox >= 1.0


def _point_weights(points: PointCloud, feat):
    if feat.weight_intensity:
        return torch.clamp(points.intensity - feat.intensity_floor, min=0.0)
    return torch.ones_like(points.intensity)


def _neighbour_offsets(noff: int):
    return [(dx, dy) for dx in range(-noff, noff + 1)
            for dy in range(-noff, noff + 1)]


def _neighbourhood(cgrid, vid, in_grid, offsets):
    """Each voxel's neighbourhood: the per-voxel columns cgrid
    (B, dim, dim, C) rolled by each offset, gathered once per point at its
    own voxel -> (B, N, C * n_off), offset-major. Wrapped-around entries
    fail the bounds test in `_member`."""
    b, dim, _, c = cgrid.shape
    ncells = dim * dim
    lane = torch.arange(b, dtype=torch.int64, device=vid.device)[:, None]
    nb = torch.cat([torch.roll(cgrid, (-dx, -dy), (1, 2))
                    for dx, dy in offsets], -1)
    vid_c = torch.clamp(torch.where(in_grid, vid, torch.full_like(vid, ncells)),
                        0, ncells - 1)
    return nb.reshape(b * ncells, c * len(offsets))[
        (lane * ncells + vid_c).reshape(-1)].reshape(b, vid.shape[1], -1)


def _own_centres(vidx, leaf, dim):
    f32 = torch.float32
    return ((vidx[..., 0].to(f32) - dim // 2 + 0.5) * leaf,
            (vidx[..., 1].to(f32) - dim // 2 + 0.5) * leaf)


def _member(xy, vidx, in_grid, nb, dx, dy, dim, res):
    """A point's membership in the cell of its (dx, dy) neighbour voxel:
    that voxel is in the grid and occupied, and its centroid (nb columns
    [cx, cy, occ]) lies within the radius `res` (the kd radius search)."""
    tx = vidx[..., 0] + dx
    ty = vidx[..., 1] + dy
    ok = in_grid & (tx >= 0) & (tx < dim) & (ty >= 0) & (ty < dim)
    d2 = ((xy - nb[..., 0:2]) ** 2).sum(-1)
    return ok & (nb[..., 2] > 0.5) & (d2 <= res * res)


def _normals_and_gates(cnt, s0, s1x, s1y, sxx, sxy, syy, vc_x, vc_y, feat):
    """Stage 3 (`pointnormal.cpp:37-62`): moments about each cell's voxel
    centre (vc_x, vc_y) -> weighted mean, normal flipped toward the sensor,
    covariance, planarity and the validity gate (occupancy left to the
    caller)."""
    safe_s0 = torch.clamp(s0, min=1e-12)
    mx, my = s1x / safe_s0, s1y / safe_s0
    cxx = sxx / safe_s0 - mx * mx
    cxy = sxy / safe_s0 - mx * my
    cyy = syy / safe_s0 - my * my
    lmin, lmax, nvec = _eig2x2_min(cxx, cxy, cyy)
    cond = torch.abs(lmax / torch.where(lmin == 0.0, lmin.new_full((), 1e-30),
                                        lmin))
    det = lmax * lmin
    gate = ((cnt >= feat.min_samples) & (s0 > 0.0) & (cond <= feat.cond_max)
            & (det > feat.det_min) & (lmin > 0.0) & (lmax > 0.0))
    mean = torch.stack([mx + vc_x, my + vc_y], -1)
    flip = (nvec * (0.0 - mean)).sum(-1) < 0.0
    nvec = torch.where(flip[..., None], -nvec, nvec)
    return mean, nvec, cxx, cxy, cyy, torch.log1p(cond / 2.0), gate


def _pre_cells(cfg) -> int:
    """Compact-cell budget of the pallas backend: it must cover the
    occupied-voxel count (~4.5k for an Oxford-scale frame's 8192 budgeted
    points); kernel G's cost is linear in it."""
    if cfg.feature.pre_cells:
        return cfg.feature.pre_cells
    return max(4608, -(-2 * cfg.feature.max_cells // 128) * 128)


def _moment_inputs(points: PointCloud, cfg):
    """Stage 1 of the pallas backend and the inputs of kernel G
    (`cuda_features.moment_accumulate`): (pack, ct_lo, ct_hi, pt_lo, pt_hi,
    offsets_m, n_off, c_pre).

    Occupied voxels get compact ranks by a cumsum in vid order (no sort);
    voxels beyond c_pre are dropped, as the reference does. Every point
    carries its own-centre offset, weight and own centre, and per
    neighbour offset its membership and the target voxel's rank (c_pre for
    none). Cell tiles are x-major slabs of the grid, so each gets the
    dilated x-range of the grid rows its ranks cover; each point tile gets
    the x-range of its in-grid points."""
    feat = cfg.feature
    leaf, dim, noff = _grid_geometry(cfg)
    c_pre = _pre_cells(cfg)
    xy = points.xy
    b, n_pts = xy.shape[0], xy.shape[1]
    dev, f32 = xy.device, xy.dtype
    if not cuda_features.supported(n_pts, c_pre):
        raise ValueError(
            f"feature.backend='pallas' needs the point count ({n_pts}) to be "
            f"a multiple of {cuda_features.PT} and pre_cells ({c_pre}) of "
            f"{cuda_features.CT}")
    vidx, in_grid, vid, _, centroid, occupied = _voxel_centroids(
        xy, points.valid, leaf, dim)

    # --- compact ranks: cumsum over the occupancy grid (vid order) ---
    ranks = torch.cumsum(occupied.to(torch.int32), -1) - 1
    rank_ok = occupied & (ranks < c_pre)
    rank_f = torch.where(rank_ok, ranks, torch.full_like(ranks, c_pre)).to(f32)

    # --- neighbourhood pack: (cx, cy, occ, rank) per offset per point ---
    w_pt = _point_weights(points, feat)
    offsets = _neighbour_offsets(noff)
    n_off = len(offsets)
    nb_pt = _neighbourhood(
        torch.cat([centroid.reshape(b, dim, dim, 2),
                   occupied.reshape(b, dim, dim, 1).to(f32),
                   rank_f.reshape(b, dim, dim, 1)], -1),
        vid, in_grid, offsets)                                # (B, N, 4 n_off)
    own_cx, own_cy = _own_centres(vidx, leaf, dim)
    mem_rows, trank_rows = [], []
    for oi, (dx, dy) in enumerate(offsets):
        trk = nb_pt[..., 4 * oi + 3]
        mem = _member(xy, vidx, in_grid, nb_pt[..., 4 * oi:4 * oi + 3], dx, dy,
                      dim, feat.res) & (trk < c_pre)
        mem_rows.append(mem.to(f32))
        trank_rows.append(torch.where(mem, trk, trk.new_full((), float(c_pre))))
    n_rows = 5 + 2 * n_off
    zero = torch.zeros_like(own_cx)
    pack = torch.stack(
        [xy[..., 0] - own_cx, xy[..., 1] - own_cy, w_pt * in_grid, own_cx,
         own_cy] + mem_rows + trank_rows
        + [zero] * (-(-n_rows // 8) * 8 - n_rows), 1).contiguous()  # (B, R, N)

    # --- tile bounds for the kernel's x-slab skip ---
    ct = cuda_features.CT
    n_ct = c_pre // ct
    row_counts = rank_ok.reshape(b, dim, dim).sum(-1)          # (B, dim)
    cum_end = torch.cumsum(row_counts, -1)
    cum_lo = cum_end - row_counts
    starts = (torch.arange(n_ct, dtype=torch.int64, device=dev) * ct
              )[None, None, :]
    has = (cum_end[..., None] > starts) & (cum_lo[..., None] < starts + ct)
    rlo = (torch.arange(dim, dtype=f32, device=dev) - dim // 2) * leaf
    rhi = rlo + leaf
    dil = feat.res + 1e-3
    inf = xy.new_full((), float("inf"))
    ct_lo = torch.where(has, rlo[None, :, None], inf).amin(1) - dil
    ct_hi = torch.where(has, rhi[None, :, None], -inf).amax(1) + dil
    pt = cuda_features.PT
    x = xy[..., 0]
    pt_lo = torch.where(in_grid, x, inf).reshape(b, n_pts // pt, pt).amin(-1)
    pt_hi = torch.where(in_grid, x, -inf).reshape(b, n_pts // pt, pt).amax(-1)
    offsets_m = tuple((dx * leaf, dy * leaf) for dx, dy in offsets)
    return (pack, ct_lo.contiguous(), ct_hi.contiguous(), pt_lo.contiguous(),
            pt_hi.contiguous(), offsets_m, n_off, c_pre)


def _compute_cells_batched_pallas(points: PointCloud, cfg) -> CellMap:
    """The pallas backend (port of the reference's
    `_compute_cells_batched_pallas`): stage 1 as the scatter form, then
    kernel G's moments over compact cells replace the (B*N, 63) scatter,
    the 9-offset roll/shift combine and the dense-grid ranking. Each cell's
    voxel centre comes back from the cnt*cx / cnt columns (no inverse rank
    map). Equal to the scatter backend up to f32 summation order, with
    integer nsamples bit-equal, while no more than c_pre voxels are
    occupied."""
    feat = cfg.feature
    leaf, dim, _ = _grid_geometry(cfg)
    acc = cuda_features.moment_accumulate(*_moment_inputs(points, cfg))
    nsamp = acc[:, 0]
    safe_cnt = torch.clamp(nsamp, min=1.0)
    vc_x = acc[:, 7] / safe_cnt
    vc_y = acc[:, 8] / safe_cnt
    mean, nvec, cxx, cxy, cyy, planarity, cell_ok = _normals_and_gates(
        *acc[:, :7].unbind(1), vc_x, vc_y, feat)
    # integer voxel indices from the exact-multiple voxel centres
    leaf_t = acc.new_full((), leaf)
    ix = torch.clamp(torch.round(vc_x / leaf_t + dim // 2 - 0.5).to(torch.int64),
                     0, dim - 1)
    iy = torch.clamp(torch.round(vc_y / leaf_t + dim // 2 - 0.5).to(torch.int64),
                     0, dim - 1)
    return _finalize_cells(mean, nvec, cxx, cxy, cyy, nsamp, planarity,
                           cell_ok, ix, iy, cfg)


def _finalize_cells(mean, nvec, cxx, cxy, cyy, nsamp, planarity, cell_ok,
                    ix, iy, cfg) -> CellMap:
    """Compaction tail: valid cells first, most-supported (largest
    nsamples) first on overflow; optional Morton re-sort of the kept cells
    (same set, spatially coherent order for the block-sparse association)."""
    feat = cfg.feature
    m = feat.max_cells
    zero = nsamp.new_zeros(())
    order = torch.argsort(-torch.where(cell_ok, nsamp + 1.0, zero), dim=-1,
                          stable=True)
    take = order[..., :m]                                     # (B, m)

    packed = torch.stack(
        [mean[..., 0], mean[..., 1], nvec[..., 0], nvec[..., 1],
         cxx, cxy, cyy, nsamp, planarity, cell_ok.to(mean.dtype)], -1)
    kept = torch.gather(packed, 1, take[..., None].expand(
        take.shape + (packed.shape[-1],)))
    kept_valid = kept[..., 9] > 0.5

    if feat.spatial_sort:
        code = _morton2(torch.gather(ix, 1, take), torch.gather(iy, 1, take))
        skey = torch.where(kept_valid, code, code.new_full((), 2 ** 30))
        order2 = torch.argsort(skey, dim=-1, stable=True)
        kept = torch.gather(kept, 1, order2[..., None].expand(kept.shape))
        kept_valid = kept[..., 9] > 0.5
    vmask = kept_valid[..., None]
    cov = torch.stack(
        [torch.stack([kept[..., 4], kept[..., 5]], -1),
         torch.stack([kept[..., 5], kept[..., 6]], -1)], -2)
    zero = kept.new_zeros(())
    return CellMap(
        mean=torch.where(vmask, kept[..., 0:2], zero),
        normal=torch.where(vmask, kept[..., 2:4], zero),
        cov=torch.where(vmask[..., None], cov, zero),
        nsamples=torch.where(kept_valid, kept[..., 7], zero),
        planarity=torch.where(kept_valid, kept[..., 8], zero),
        valid=kept_valid,
    )


def compute_raw_cells(points: PointCloud, cfg) -> CellMap:
    """The `use_raw_pointcloud` ablation: one identity cell per filtered
    point (`cell::GetIdentityCell`, `pointnormal.h:62,79-81`): mean = point,
    cov = 0.1 I, normal (1, 0), planarity 1, nsamples 1. The fixed budget
    keeps the first `max_cells_raw` valid points in point order; leaves
    carry any leading lane axes, each lane compacted on its own."""
    m = cfg.feature.max_cells_raw
    order = torch.argsort((~points.valid).to(torch.int32), dim=-1,
                          stable=True)[..., :m]
    valid = torch.gather(points.valid, -1, order)
    xy = torch.gather(points.xy, -2, order[..., None].expand(
        order.shape + (2,)))
    zero = xy.new_zeros(())
    v2 = valid[..., None]
    eye = 0.1 * torch.eye(2, dtype=xy.dtype, device=xy.device)
    normal = torch.tensor([1.0, 0.0], dtype=xy.dtype, device=xy.device)
    one = torch.where(valid, xy.new_ones(()), zero)
    return CellMap(mean=torch.where(v2, xy, zero),
                   normal=torch.where(v2, normal, zero),
                   cov=torch.where(v2[..., None], eye, zero),
                   nsamples=one, planarity=one, valid=valid)


def transform_cells(cells: CellMap, pose) -> CellMap:
    """Rigid-transform cell maps (..., M, ...) by SE(2) poses (..., 3)
    (`cell::TransformCopy`, `pointnormal.cpp:515-529`, with the covariance
    rotated as R Sigma R^T, as the reference does)."""
    R = se2.rotmat(pose[..., 2])
    cov = torch.einsum("...ij,...njk,...lk->...nil", R, cells.cov, R)
    return cells._replace(mean=se2.transform(pose, cells.mean),
                          normal=se2.rotate(pose, cells.normal), cov=cov)


def compensate_cells(cells: CellMap, tmot, ccw: bool) -> CellMap:
    """Motion-compensate cell means, normals and covariances (..., M, ...)
    by each cell's relative scan time and the motion tmot (..., 3)
    (`MapPointNormal::Compensate`, `pointnormal.cpp:113-133`)."""
    d = se2.rel_timestamp(cells.mean, ccw)                   # (..., M)
    ang = d * tmot[..., None, 2]
    c, s = torch.cos(ang), torch.sin(ang)
    x, y = cells.mean[..., 0], cells.mean[..., 1]
    mean = torch.stack([c * x - s * y + d * tmot[..., None, 0],
                        s * x + c * y + d * tmot[..., None, 1]], -1)
    nx, ny = cells.normal[..., 0], cells.normal[..., 1]
    normal = torch.stack([c * nx - s * ny, s * nx + c * ny], -1)
    R = se2.rotmat(ang)
    cov = torch.einsum("...nij,...njk,...nlk->...nil", R, cells.cov, R)
    return cells._replace(mean=mean, normal=normal, cov=cov)
