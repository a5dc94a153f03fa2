"""Oriented surface points ("cells") (port of `ops/features.py`).

Three dense passes over a static per-lane voxel grid, batched over lanes:

1. scatter-add points into the grid -> per-voxel unweighted centroid;
2. for each of the 9 neighbour offsets, test every point against the
   neighbour voxel's centroid (exact circular radius test) and scatter-add
   its weighted moments into its OWN voxel, then roll each offset's grid
   onto the target voxel and shift the moment origin in closed form;
3. closed-form 2x2 eigendecomposition, the validity gates of
   `pointnormal.cpp:53-56`, and compaction to `max_cells`.

`jax.ops.segment_sum` becomes `index_add_` (float atomics on CUDA, so the
summation order, and the last bits of the moments, can change from run to
run). Both ranking sorts are stable, as `jnp.argsort` is.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cfear_radarodometry_code_public_tpu_torch.ops.filtering import PointCloud


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
    lane * ncells)."""
    feat = cfg.feature
    if feat.use_raw_pointcloud:
        raise NotImplementedError(
            "feature.use_raw_pointcloud is not ported yet (ROADMAP queue 1, "
            "item 5: compute_raw_cells)")
    if feat.backend == "pallas":
        raise NotImplementedError(
            "feature.backend='pallas' is not ported yet (ROADMAP queue 2, "
            "kernel G: moment_accumulate)")
    leaf, dim, noff = _grid_geometry(cfg)
    ncells = dim * dim
    p = feat.point_budget
    if p and p < points.xy.shape[1]:
        points = budget_points(points, p)

    xy = points.xy                                            # (B, N, 2)
    b, n_pts = xy.shape[0], xy.shape[1]
    dev, f32 = xy.device, xy.dtype
    valid = points.valid
    lane = torch.arange(b, dtype=torch.int64, device=dev)[:, None]

    # --- stage 1: voxel centroids (unweighted, like pcl::VoxelGrid) ---
    # divide by a device tensor: a Python divisor makes CUDA multiply by its
    # f32 reciprocal, which moves boundary points to the neighbour voxel
    vidx = torch.floor(xy / torch.full((), leaf, dtype=f32, device=dev)
                       ).to(torch.int64) + dim // 2
    in_grid = valid & ((vidx >= 0) & (vidx < dim)).all(-1)
    vid = vidx[..., 0] * dim + vidx[..., 1]                   # (B, N)
    vid_flat = torch.where(in_grid, lane * ncells + vid,
                           torch.full_like(vid, b * ncells)).reshape(-1)
    ones = in_grid.to(f32)
    s1 = torch.zeros((b * ncells + 1, 3), dtype=f32, device=dev)
    s1.index_add_(0, vid_flat, torch.cat(
        [ones[..., None], xy * ones[..., None]], -1).reshape(b * n_pts, 3))
    s1 = s1[:b * ncells].reshape(b, ncells, 3)
    cnt_vox, sum_vox = s1[..., 0], s1[..., 1:3]
    centroid = sum_vox / torch.clamp(cnt_vox, min=1.0)[..., None]
    occupied = cnt_vox >= 1.0

    # --- stage 2: weighted moments per candidate cell ---
    if feat.weight_intensity:
        w_pt = torch.clamp(points.intensity - feat.intensity_floor, min=0.0)
    else:
        w_pt = torch.ones_like(points.intensity)

    offsets = [(dx, dy) for dx in range(-noff, noff + 1)
               for dy in range(-noff, noff + 1)]
    n_off = len(offsets)
    # each voxel's neighbourhood (centroid x/y + occupancy per offset),
    # gathered once per point; wrapped-around entries fail the bounds test
    cgrid = torch.cat([centroid.reshape(b, dim, dim, 2),
                       occupied.reshape(b, dim, dim, 1).to(f32)], -1)
    nb = torch.cat([torch.roll(cgrid, (-dx, -dy), (1, 2))
                    for dx, dy in offsets], -1)
    vid_c = torch.clamp(torch.where(in_grid, vid, torch.full_like(vid, ncells)),
                        0, ncells - 1)
    nb_pt = nb.reshape(b * ncells, 3 * n_off)[
        (lane * ncells + vid_c).reshape(-1)].reshape(b, n_pts, 3 * n_off)

    # moments about the OWN voxel centre, shifted to the target centre later
    own_cx = (vidx[..., 0].to(f32) - dim // 2 + 0.5) * leaf
    own_cy = (vidx[..., 1].to(f32) - dim // 2 + 0.5) * leaf
    rx = xy[..., 0] - own_cx
    ry = xy[..., 1] - own_cy
    base = torch.stack(
        [torch.ones_like(w_pt), w_pt, w_pt * rx, w_pt * ry,
         w_pt * rx * rx, w_pt * rx * ry, w_pt * ry * ry], -1)  # (B, N, 7)

    mem_cols = []
    for oi, (dx, dy) in enumerate(offsets):
        tx = vidx[..., 0] + dx
        ty = vidx[..., 1] + dy
        ok = in_grid & (tx >= 0) & (tx < dim) & (ty >= 0) & (ty < dim)
        c = nb_pt[..., 3 * oi:3 * oi + 2]
        occ = nb_pt[..., 3 * oi + 2] > 0.5
        d2 = ((xy - c) ** 2).sum(-1)
        mem_cols.append(ok & occ & (d2 <= feat.res * feat.res))
    mem = torch.stack(mem_cols, -1).to(f32)                   # (B, N, n_off)

    data = (mem[..., :, None] * base[..., None, :]).reshape(b * n_pts, n_off * 7)
    acc_own = torch.zeros((b * ncells + 1, n_off * 7), dtype=f32, device=dev)
    acc_own.index_add_(0, vid_flat, data)
    acc_own = acc_own[:b * ncells].reshape(b, dim, dim, n_off, 7)

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
    acc = acc.reshape(b, ncells, 7)
    nsamp, s0 = acc[..., 0], acc[..., 1]

    safe_s0 = torch.clamp(s0, min=1e-12)
    mx, my = acc[..., 2] / safe_s0, acc[..., 3] / safe_s0
    cxx = acc[..., 4] / safe_s0 - mx * mx
    cxy = acc[..., 5] / safe_s0 - mx * my
    cyy = acc[..., 6] / safe_s0 - my * my

    ii = torch.arange(dim, dtype=f32, device=dev) - dim // 2 + 0.5
    vc_x = ii.repeat_interleave(dim) * leaf                   # (ncells,)
    vc_y = ii.repeat(dim) * leaf

    # --- stage 3: normals + validity gates (`pointnormal.cpp:37-62`) ---
    lmin, lmax, nvec = _eig2x2_min(cxx, cxy, cyy)
    cond = torch.abs(lmax / torch.where(lmin == 0.0, lmin.new_full((), 1e-30),
                                        lmin))
    det = lmax * lmin
    cell_ok = (occupied & (nsamp >= feat.min_samples) & (s0 > 0.0)
               & (cond <= feat.cond_max) & (det > feat.det_min)
               & (lmin > 0.0) & (lmax > 0.0))
    mean = torch.stack([mx + vc_x, my + vc_y], -1)
    # flip the normal toward the sensor origin (`pointnormal.cpp:59-61`)
    flip = (nvec * (0.0 - mean)).sum(-1) < 0.0
    nvec = torch.where(flip[..., None], -nvec, nvec)
    planarity = torch.log1p(cond / 2.0)

    ib = torch.arange(ncells, dtype=torch.int64, device=dev)[None].expand(b, -1)
    return _finalize_cells(mean, nvec, cxx, cxy, cyy, nsamp, planarity,
                           cell_ok, ib // dim, ib % dim, cfg)


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
