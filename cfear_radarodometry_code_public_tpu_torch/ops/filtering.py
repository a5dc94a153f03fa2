"""Host-ingest half of the filter stage (port of `ops/filtering.py`).

Only the main path is ported: the native host filter
(`_shared.native_io`) selects the k-strongest candidates on CPU threads, and
these functions turn its rows into a fixed-size masked point cloud on the
device. Conventions (`radar_filters.cpp:315-330`): theta = (azimuth+1)/A*2pi,
range = (bin+0.5)*dr. The on-device image filter (k-strongest, NMS, CA-CFAR)
is not ported yet.

All functions accept any leading batch axes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class PointCloud(NamedTuple):
    """Fixed-size masked 2-D point set (one slot per candidate)."""

    xy: torch.Tensor          # (..., N, 2) float32, garbage where ~valid
    intensity: torch.Tensor   # (..., N) float32
    valid: torch.Tensor       # (..., N) bool
    peak: torch.Tensor        # (..., N) bool

    @property
    def n(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


class Candidates(NamedTuple):
    """Per-azimuth k-strongest candidates from the host filter; one frame is
    (A, K) per field."""

    bins: torch.Tensor        # int16 — selected range bins, -1 for empty slots
    intensity: torch.Tensor   # uint8
    peak: torch.Tensor        # uint8 — axial-NMS peak flag


class CompactCandidates(NamedTuple):
    """Point-budget-compacted candidate rows from the host filter
    (`native_io.filter_frames_host_compact`); one frame is (P,) per field."""

    bins: torch.Tensor        # int16 — selected range bins, -1 for padding
    azimuth: torch.Tensor     # int16 — source azimuth row of each candidate
    intensity: torch.Tensor   # uint8
    peak: torch.Tensor        # uint8 — axial-NMS peak flag


def _theta(azimuth, n_azimuths: int):
    return (azimuth.to(torch.int32) + 1).to(torch.float32) / n_azimuths \
        * (2.0 * math.pi)


def polar_to_points(bins, valid, intens, peaks, cfg) -> PointCloud:
    """(..., A, k) selected bins -> flat fixed-size Cartesian point cloud,
    with the min-distance bin gate (k-strongest convention)."""
    radar = cfg.radar
    a = radar.n_azimuths
    az = torch.arange(a, device=bins.device)[:, None].expand(bins.shape[-2:])
    theta = _theta(az, a)
    rng = (bins.to(torch.float32) + 0.5) * radar.range_res
    min_bin = int(math.ceil(radar.min_distance / radar.range_res))
    keep = valid & (bins > min_bin)
    xy = torch.stack([rng * torch.cos(theta), rng * torch.sin(theta)], -1)
    lead = bins.shape[:-2]
    return PointCloud(
        xy=xy.reshape(lead + (-1, 2)),
        intensity=intens.to(torch.float32).reshape(lead + (-1,)),
        valid=keep.reshape(lead + (-1,)),
        peak=(keep & peaks).reshape(lead + (-1,)),
    )


def points_from_candidates(cand: Candidates, cfg) -> PointCloud:
    """Candidates (..., A, K) -> point cloud (..., A*K)."""
    if cfg.filter.method == "cacfar":
        raise NotImplementedError(
            "filter.method='cacfar' is not ported yet (ROADMAP queue 1, "
            "item 4: the on-device image-ingest filters)")
    bins = cand.bins.to(torch.int32)
    valid = bins >= 0
    return polar_to_points(torch.clamp(bins, min=0), valid, cand.intensity,
                           cand.peak.to(torch.bool), cfg)


def points_from_compact(cand: CompactCandidates, cfg) -> PointCloud:
    """Compact rows (..., P) -> point cloud (..., P). The min-range bin gate
    was already applied on the host."""
    radar = cfg.radar
    bins = cand.bins.to(torch.int32)
    valid = bins >= 0
    theta = _theta(cand.azimuth, radar.n_azimuths)
    rng = (torch.clamp(bins, min=0).to(torch.float32) + 0.5) * radar.range_res
    xy = torch.stack([rng * torch.cos(theta), rng * torch.sin(theta)], -1)
    return PointCloud(
        xy=xy,
        intensity=cand.intensity.to(torch.float32),
        valid=valid,
        peak=valid & cand.peak.to(torch.bool),
    )
