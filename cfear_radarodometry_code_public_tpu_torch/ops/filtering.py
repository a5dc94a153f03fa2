"""Polar-image return filtering (port of `ops/filtering.py`).

Two ingest halves, both ported:

- on the device, from the raw uint8 polar sweep (`filter_polar_image`):
  per-azimuth k-strongest selection by `torch.topk` over a composite key,
  the axial NMS peaks as a windowed sum + windowed max over the dense image,
  or, with `filter.method="cacfar"`, CA-CFAR detections from exact integer
  prefix sums, kept to a fixed per-azimuth budget;
- from the native host filter's rows (`utils/native_io`):
  `points_from_candidates` and `points_from_compact`.

Conventions (`radar_filters.cpp:315-330`): theta = (azimuth+1)/A*2pi;
k-strongest range = (bin+0.5)*dr with the min-distance bin gate; CA-CFAR
range = bin*dr with no extra gate (`cfar.cpp:42-46`). Every function takes
any leading batch axes; the image is (..., A, R) uint8.
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


def _f32(v, like):
    """A float32 scalar tensor on `like`'s device: the reference's
    `jnp.float32(v)` operand, so a compare or product rounds v to f32
    exactly as it does. Filled on the device, not copied from the host: a
    host-to-device copy of a scalar waits for the stream."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _bins_iota(image):
    """Range-bin index of every pixel, int32, broadcastable to the image."""
    return torch.arange(image.shape[-1], dtype=torch.int32,
                        device=image.device)


def _windowed_sum(img_f32, w: int):
    """Sum over [r-w, r+w] along the last axis, zero-padded borders. Exact
    for uint8 images in f32 at any order (255 * 3,774 < 2**24)."""
    pad = torch.nn.functional.pad(img_f32, (w, w))
    cs = torch.nn.functional.pad(torch.cumsum(pad, -1), (1, 0))
    return cs[..., 2 * w + 1:] - cs[..., :-(2 * w + 1)]


def _windowed_max(x, w: int):
    """Max over [r-w, r+w] along the last axis."""
    out = x
    inf = float("-inf")
    for shift in range(1, w + 1):
        left = torch.nn.functional.pad(x[..., shift:], (0, shift), value=inf)
        right = torch.nn.functional.pad(x[..., :-shift], (shift, 0),
                                        value=inf)
        out = torch.maximum(out, torch.maximum(left, right))
    return out


def _top_bins(key, k: int, shift: int):
    """The k largest composite keys (intensity * shift + bin, -1 where not
    selectable) per azimuth, largest first -> (bins, valid, intensity)."""
    topv = torch.topk(key, k, dim=-1, sorted=True).values
    valid = topv >= 0
    zero = topv.new_zeros(())
    return (torch.where(valid, topv % shift, zero), valid,
            torch.where(valid, topv // shift, zero))


def kstrongest_mask(image, k: int, z_min):
    """Per-azimuth k-strongest selection: (..., A, k) int32 range bins and
    bool mask of the k strongest bins with intensity >= z_min. On equal
    intensity the larger range bin wins, as the reference's sorted insert
    (`radar_filters.cpp:225-228`). `z_min` is an int or a per-frame int
    tensor of the image's leading shape (`frame_noise_threshold`)."""
    r = image.shape[-1]
    intens = image.to(torch.int32)
    shift = 1 << (r - 1).bit_length()
    if torch.is_tensor(z_min):
        z_min = z_min[..., None, None]
    key = torch.where(intens >= z_min, intens * shift + _bins_iota(image),
                      intens.new_full((), -1))
    bins, valid, _ = _top_bins(key, k, shift)
    return bins, valid


def frame_noise_threshold(image, q: float, z_min: int):
    """Adaptive per-frame noise-floor threshold: max(z_min, q_thr + 1), with
    q_thr the smallest uint8 value whose CDF reaches ceil(q * A * R) pixels
    (exact integer rule, reproduced by the native host filter). The
    histogram is the reference's integer scatter-add, one 256-bin row per
    frame: exact in any order, and unlike `torch.bincount` it does not read
    its input's maximum back from a card. Returns an int32 tensor of the
    image's leading shape."""
    lead = image.shape[:-2]
    n_frames = math.prod(lead)
    dev = image.device
    idx = image.reshape(n_frames, -1).to(torch.int64) \
        + 256 * torch.arange(n_frames, device=dev)[:, None]
    ones = torch.ones(1, dtype=torch.int32, device=dev).expand(idx.numel())
    hist = torch.zeros(n_frames * 256, dtype=torch.int32, device=dev
                       ).scatter_add_(0, idx.reshape(-1), ones)
    cdf = torch.cumsum(hist.reshape(n_frames, 256), -1)
    q_count = int(math.ceil(q * image.shape[-2] * image.shape[-1]))
    q_thr = torch.argmax((cdf >= q_count).to(torch.int32), -1)
    return torch.clamp(q_thr + 1, min=z_min).to(torch.int32).reshape(lead)


def nms_peak_image(image, w: int):
    """Dense bool (..., A, R): the bin is a local max of the (2w+1)-bin
    summed intensity and lies w or more bins from either border."""
    r = image.shape[-1]
    score = _windowed_sum(image.to(torch.float32), w)
    bins = _bins_iota(image)
    return (score >= _windowed_max(score, w)) & (bins >= w) & (bins < r - w)


def cacfar_mask(image, cfg):
    """Cell-averaging CFAR detections along range, per azimuth
    (`AzimuthCACFAR::getFilteredPointCloud`, `cfar.cpp:35-71`), bin-exact:
    with alpha = N (Pfa^(-1/N) - 1), N = 2 * window, a cell in
    (min_distance, cfar_max_distance) with intensity > static_threshold is
    detected if I^2 > alpha * (trailing_mean + forward_mean) / 2, the
    trailing window over [r-g-w, r-g-1] and the forward window over
    [r+g, r+g+w-1] clamped to the image; a window wholly outside the image
    never detects. The window sums are exact integers, and the test is
    cross-multiplied into one f32 comparison, as in the reference:
    2 I^2 t_cnt f_cnt > alpha (t_sum f_cnt + f_sum t_cnt)."""
    f, radar = cfg.filter, cfg.radar
    win, guard = f.cfar_window, f.cfar_guard
    alpha = (2 * win) * (f.false_alarm_rate ** (-1.0 / (2 * win)) - 1.0)
    r = image.shape[-1]
    sq = image.to(torch.int64) ** 2
    prefix = torch.nn.functional.pad(torch.cumsum(sq, -1), (1, 0))
    bins = _bins_iota(image).to(torch.int64)
    t_lo = torch.clamp(bins - guard - win, 0, r)
    t_hi = torch.clamp(bins - guard, 0, r)
    f_lo = torch.clamp(bins + guard, 0, r)
    f_hi = torch.clamp(bins + guard + win, 0, r)

    def at(idx):
        return prefix[..., idx]

    t_cnt = t_hi - t_lo
    f_cnt = f_hi - f_lo
    t_sum = at(t_hi) - at(t_lo)
    f_sum = at(f_hi) - at(f_lo)
    lhs = (2 * sq * t_cnt * f_cnt).to(torch.float32)
    rhs = _f32(alpha, image) * (t_sum * f_cnt + f_sum * t_cnt
                                ).to(torch.float32)
    rng = bins.to(torch.float32) * _f32(radar.range_res, image)
    return ((rng > _f32(radar.min_distance, image))
            & (rng < _f32(f.cfar_max_distance, image))
            & (image.to(torch.float32) > _f32(f.static_threshold, image))
            & (lhs > rhs) & (t_cnt > 0) & (f_cnt > 0))


def cfar_select(image, cfg):
    """CA-CFAR detections kept to the per-azimuth budget
    `cfar_max_per_azimuth` (strongest first, larger bin on equal intensity):
    (bins (..., A, Kc) int32, valid bool, intensities int32)."""
    det = cacfar_mask(image, cfg)
    r = image.shape[-1]
    intens = image.to(torch.int32)
    shift = 1 << (r - 1).bit_length()
    key = torch.where(det, intens * shift + _bins_iota(image),
                      intens.new_full((), -1))
    return _top_bins(key, cfg.filter.cfar_max_per_azimuth, shift)


def polar_to_points(bins, valid, intens, peaks, cfg,
                    convention: str = "kstrong") -> PointCloud:
    """(..., A, k) selected bins -> flat fixed-size Cartesian point cloud.
    `convention="kstrong"`: range = (bin+0.5)*dr with the min-distance bin
    gate; `"cacfar"`: range = bin*dr and no gate (the CFAR mask applied the
    range window, `cfar.cpp:42-46`)."""
    radar = cfg.radar
    a = radar.n_azimuths
    az = torch.arange(a, device=bins.device)[:, None].expand(bins.shape[-2:])
    theta = _theta(az, a)
    if convention == "cacfar":
        rng = bins.to(torch.float32) * radar.range_res
        keep = valid
    else:
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
    """Candidates (..., A, K) -> point cloud (..., A*K): the device half of
    the host ingest, equal to `filter_polar_image` on the same images."""
    bins = cand.bins.to(torch.int32)
    valid = bins >= 0
    return polar_to_points(torch.clamp(bins, min=0), valid, cand.intensity,
                           cand.peak.to(torch.bool), cfg,
                           convention="cacfar" if cfg.filter.method ==
                           "cacfar" else "kstrong")


def filter_polar_image(image, cfg) -> PointCloud:
    """Full filter stage on the device: polar uint8 sweeps (..., A, R) ->
    masked point cloud (..., A*k) (`radarDriver::Process`,
    `radar_driver.cpp:48-73`). By default the k-strongest cloud and its NMS
    peaks; with `filter.method="cacfar"` the CA-CFAR detections replace
    k-strongest and the peaks set is empty (`radar_driver.cpp:50-57`)."""
    f = cfg.filter
    if f.method == "cacfar":
        bins, valid, intens = cfar_select(image, cfg)
        return polar_to_points(bins, valid, intens, torch.zeros_like(valid),
                               cfg, convention="cacfar")
    z = f.z_min
    if f.z_min_quantile:
        z = frame_noise_threshold(image, f.z_min_quantile, f.z_min)
    bins, valid = kstrongest_mask(image, f.k_strongest, z)
    idx = bins.to(torch.int64)
    peaks = torch.gather(nms_peak_image(image, f.nms_window), -1, idx) & valid
    intens = torch.gather(image, -1, idx)
    return polar_to_points(bins, valid, intens, peaks, cfg)


def intensity_filter(pc: PointCloud, threshold: float = 50.0,
                     min_range: float = 0.0, max_range: float = 150.0
                     ) -> PointCloud:
    """Mask points by intensity threshold and range window
    (`IntensityFilter`, `utils.cpp:3-19`)."""
    d2 = (pc.xy ** 2).sum(-1)
    keep = (pc.valid & (pc.intensity >= threshold)
            & (d2 > min_range * min_range) & (d2 < max_range * max_range))
    return pc._replace(valid=keep, peak=pc.peak & keep)


def add_noise(pc: PointCloud, generator: torch.Generator,
              sigma: float = 0.1) -> PointCloud:
    """Jitter the valid points' xy by Gaussian noise (`AddNoise`,
    `utils.cpp:71-74`); `generator` (on the points' device) takes the place
    of the reference's JAX key — a test utility."""
    noise = sigma * torch.randn(pc.xy.shape, generator=generator,
                                dtype=pc.xy.dtype, device=pc.xy.device)
    return pc._replace(xy=pc.xy + torch.where(pc.valid[..., None], noise,
                                              noise.new_zeros(())))


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
