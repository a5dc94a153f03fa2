"""The port's image-ingest filters (`ops/filtering.py`) against the JAX
reference and the loop-level oracles of `tests/oracles.py`, on random
images of 64 x 256 and of an odd width (64 x 251).

Tolerances: masks, bins, peaks, intensities and thresholds are integers and
are compared exactly. Cartesian points go through f32 sin/cos, which differ
by an ulp between XLA and torch, so xy against JAX is held to 1e-6 plus 2
ulps of the range (rtol 2.4e-7, 2 float32 epsilons); the port's device and
host ingest use the same torch ops and are held to 1e-6 absolute, the
tolerance of `tests/test_filtering.py:166`. Against the double-precision
oracles, 2e-3 as in `tests/test_filtering.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import both_cfgs, jnp, ref

from cfear_radarodometry_code_public_tpu.ops import filtering as jf
from cfear_radarodometry_code_public_tpu_torch.ops import filtering as tf
from cfear_radarodometry_code_public_tpu_torch.utils import native_io as tnio
from oracles import (cacfar_oracle, kstrongest_oracle, nms_peaks_oracle,
                     points_oracle)

WIDTHS = (256, 251)
XY_RTOL = 2 * float(np.finfo(np.float32).eps)


def _cfgs(n_bins=256, **filt):
    cfg = ref.preset("CFEAR-3", dataset="synthetic")
    radar = dataclasses.replace(cfg.radar, n_azimuths=64, n_bins=n_bins,
                                range_res=0.5)
    filt = dataclasses.replace(cfg.filter, **{"k_strongest": 8, "z_min": 60,
                                              **filt})
    return both_cfgs(cfg.replace(radar=radar, filter=filt))


def _cfar_cfgs(n_bins=256, kc=50):
    return _cfgs(n_bins, method="cacfar", cfar_window=8, cfar_guard=2,
                 cfar_max_per_azimuth=kc)


def rand_image(rng, a, r):
    """`tests/test_filtering.rand_image`: a noise floor under 80 with
    strong returns sprinkled in."""
    img = rng.integers(0, 80, (a, r), dtype=np.int64)
    for _ in range(a * 4):
        az, b = rng.integers(0, a), rng.integers(0, r)
        img[az, b] = rng.integers(60, 256)
    return np.clip(img, 0, 255).astype(np.uint8)


def _canon(a):
    """(x, y, intensity) rows in an order that f32 jitter cannot change
    (`tests/test_filtering.py`)."""
    key = np.round(a, 3)
    return a[np.lexsort((key[:, 2], key[:, 1], key[:, 0]))]


def _pair(img):
    return jnp.asarray(img), torch.as_tensor(img)


def _assert_cloud(got, want):
    """Port point cloud against the reference's: masks and intensities
    exact, xy on the valid slots within the module tolerance."""
    for name in ("valid", "peak", "intensity"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    v = np.asarray(want.valid)
    np.testing.assert_allclose(got.xy.numpy()[v], np.asarray(want.xy)[v],
                               rtol=XY_RTOL, atol=1e-6)


@pytest.mark.parametrize("width", WIDTHS)
def test_windowed_sum_and_max_equal_jax(width):
    rng = np.random.default_rng(10 + width)
    img = rand_image(rng, 64, width)
    j, t = _pair(img)
    for w in (1, 3):
        s_j = jf._windowed_sum(j.astype(jnp.float32), w)
        s_t = tf._windowed_sum(t.to(torch.float32), w)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(tf._windowed_max(s_t, w).numpy(),
                                      np.asarray(jf._windowed_max(s_j, w)))


@pytest.mark.parametrize("width", WIDTHS)
def test_kstrongest_and_nms_equal_jax_and_oracle(width):
    rng = np.random.default_rng(width)
    img = rand_image(rng, 64, width)
    j, t = _pair(img)
    bins_j, valid_j = jf.kstrongest_mask(j, 8, 60)
    bins_t, valid_t = tf.kstrongest_mask(t, 8, 60)
    assert bins_t.dtype == torch.int32
    np.testing.assert_array_equal(bins_t.numpy(), np.asarray(bins_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    kept = kstrongest_oracle(img, 8, 60)
    peak_t = tf.nms_peak_image(t, 3).numpy()
    np.testing.assert_array_equal(peak_t, np.asarray(jf.nms_peak_image(j, 3)))
    expect_peaks = nms_peaks_oracle(img, kept, 3)
    b, v = bins_t.numpy(), valid_t.numpy()
    for az in range(64):
        assert sorted(b[az][v[az]].tolist()) == kept[az], az
        assert sorted(x for x, ok in zip(b[az], v[az])
                      if ok and peak_t[az, x]) == expect_peaks[az], az


def test_kstrongest_tie_break_prefers_larger_bin():
    """`tests/test_filtering.py:42`: three equal intensities, k=2 -> the two
    larger bins, in the reference's slot order."""
    img = np.zeros((64, 256), np.uint8)
    img[0, [10, 20, 30]] = 100
    j, t = _pair(img)
    bins_t, valid_t = tf.kstrongest_mask(t, 2, 60)
    bins_j, valid_j = jf.kstrongest_mask(j, 2, 60)
    assert sorted(bins_t[0][valid_t[0]].tolist()) == [20, 30]
    np.testing.assert_array_equal(bins_t.numpy(), np.asarray(bins_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))


@pytest.mark.parametrize("q", [0.5, 0.9, 0.98, 1.0])
def test_frame_noise_threshold_equals_jax_and_host(q):
    """Exact per frame, also batched over frames; the native host filter's
    thresholds are the same integers."""
    rng = np.random.default_rng(int(q * 100))
    imgs = np.stack([rand_image(rng, 64, w)[:, :251] for w in (256, 256)])
    imgs[1] //= 3
    got = tf.frame_noise_threshold(torch.as_tensor(imgs), q, 60)
    assert got.shape == (2,) and got.dtype == torch.int32
    for i in range(2):
        want = int(jf.frame_noise_threshold(jnp.asarray(imgs[i]), q, 60))
        assert int(got[i]) == want
        assert int(tf.frame_noise_threshold(torch.as_tensor(imgs[i]), q,
                                            60)) == want
    np.testing.assert_array_equal(
        got.numpy(), tnio.frame_thresholds_host(imgs, q, 60))


@pytest.mark.parametrize("width", WIDTHS)
def test_cacfar_equals_jax_and_oracle(width):
    rng = np.random.default_rng(3 + width)
    img = rand_image(rng, 64, width)
    cfg_j, cfg_t = _cfar_cfgs(width)
    j, t = _pair(img)
    np.testing.assert_array_equal(tf.cacfar_mask(t, cfg_t).numpy(),
                                  np.asarray(jf.cacfar_mask(j, cfg_j)))
    for got, want in zip(tf.cfar_select(t, cfg_t), jf.cfar_select(j, cfg_j)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pc = tf.filter_polar_image(t, cfg_t)
    _assert_cloud(pc, jf.filter_polar_image(j, cfg_j))
    assert not pc.peak.any()
    f, radar = cfg_t.filter, cfg_t.radar
    expect = cacfar_oracle(img, f.cfar_window, f.cfar_guard,
                           f.false_alarm_rate, radar.range_res,
                           f.static_threshold, radar.min_distance,
                           f.cfar_max_distance)
    v = pc.valid.numpy()
    got = np.concatenate([pc.xy.numpy()[v], pc.intensity.numpy()[v][:, None]],
                         -1)
    assert got.shape == expect.shape
    np.testing.assert_allclose(_canon(got), _canon(expect), atol=2e-3)


def test_cacfar_borders_and_isolated_return():
    """`tests/test_filtering.py:88`: a uniform image detects nothing (also
    at the borders); one strong return on a low floor is the only
    detection."""
    cfg_j, cfg_t = _cfar_cfgs()
    img = np.full((64, 256), 200, np.uint8)
    assert not tf.cacfar_mask(torch.as_tensor(img), cfg_t).any()
    img2 = np.full((64, 256), 10, np.uint8)
    img2[5, 100] = 250
    got = tf.cacfar_mask(torch.as_tensor(img2), cfg_t).numpy()
    assert got[5, 100] and got.sum() == 1
    np.testing.assert_array_equal(
        got, np.asarray(jf.cacfar_mask(jnp.asarray(img2), cfg_j)))


def test_cacfar_overflow_keeps_strongest():
    """`tests/test_filtering.py:168`: five detections on one azimuth over a
    budget of 3 -> the three strongest, slots as the reference's."""
    cfg_j, cfg_t = _cfar_cfgs(kc=3)
    img = np.full((64, 256), 5, np.uint8)
    img[7, [40, 70, 100, 130, 160]] = [200, 210, 220, 230, 240]
    got = tf.cfar_select(torch.as_tensor(img), cfg_t)
    want = jf.cfar_select(jnp.asarray(img), cfg_j)
    assert sorted(got[0][7][got[1][7]].tolist()) == [100, 130, 160]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("method,q", [("kstrong", 0.0), ("kstrong", 0.9),
                                      ("cacfar", 0.0)])
@pytest.mark.parametrize("width", WIDTHS)
def test_filter_polar_image_equals_jax_and_oracle(method, q, width):
    """Both methods, batched over two frames: each frame's cloud equals the
    reference's (masks exact, xy within tolerance) and, for k-strongest,
    the oracle's point set."""
    rng = np.random.default_rng(7 + width)
    imgs = np.stack([rand_image(rng, 64, width) for _ in range(2)])
    cfg_j, cfg_t = _cfgs(width, method=method, z_min_quantile=q,
                         cfar_window=8, cfar_guard=2)
    batched = tf.filter_polar_image(torch.as_tensor(imgs), cfg_t)
    for i in range(2):
        want = jf.filter_polar_image(jnp.asarray(imgs[i]), cfg_j)
        _assert_cloud(tf.PointCloud(*(a[i] for a in batched)), want)
    if method == "kstrong" and not q:
        v = batched.valid[0].numpy()
        got = np.concatenate([batched.xy[0].numpy()[v],
                              batched.intensity[0].numpy()[v][:, None]], -1)
        kept = kstrongest_oracle(imgs[0], 8, 60)
        expect = points_oracle(imgs[0], kept, 0.5, cfg_t.radar.min_distance)
        assert got.shape == expect.shape
        np.testing.assert_allclose(_canon(got), _canon(expect), atol=2e-3)


@pytest.mark.parametrize("method,q", [("kstrong", 0.0), ("kstrong", 0.9),
                                      ("cacfar", 0.0)])
def test_points_from_candidates_equals_filter_polar_image(method, q):
    """The host ingest (native rows -> `points_from_candidates`) gives the
    device filter's cloud: masks exact, xy within 1e-6 (both CFAR and
    k-strongest)."""
    rng = np.random.default_rng(4)
    imgs = np.stack([rand_image(rng, 64, 256) for _ in range(3)])
    _, cfg_t = _cfgs(method=method, z_min_quantile=q, cfar_window=8,
                     cfar_guard=2)
    f = cfg_t.filter
    if method == "cacfar":
        rows = tnio.cfar_filter_frames_host(imgs, cfg_t)
    else:
        rows = tnio.filter_frames_host(imgs, f.k_strongest, f.z_min,
                                       f.nms_window, z_quantile=q)
    cand = tf.Candidates(*(torch.as_tensor(a) for a in rows))
    host = tf.points_from_candidates(cand, cfg_t)
    dev = tf.filter_polar_image(torch.as_tensor(imgs), cfg_t)
    for name in ("valid", "peak", "intensity"):
        np.testing.assert_array_equal(getattr(host, name).numpy(),
                                      getattr(dev, name).numpy(), name)
    v = dev.valid.numpy()
    assert v.any()
    np.testing.assert_allclose(host.xy.numpy()[v], dev.xy.numpy()[v],
                               rtol=0, atol=1e-6)


def test_polar_to_points_cacfar_convention():
    """`convention="cacfar"`: range = bin * dr, no min-distance gate;
    k-strongest: (bin + 0.5) * dr and bins at or under ceil(min/dr) drop."""
    cfg_j, cfg_t = _cfgs()
    a = cfg_t.radar.n_azimuths
    bins = np.zeros((a, 2), np.int32)
    bins[:, 0], bins[:, 1] = 3, 40            # bin 3 is inside 2.5 m / 0.5
    valid = np.ones((a, 2), bool)
    intens = np.full((a, 2), 100, np.uint8)
    peaks = np.zeros((a, 2), bool)
    for conv in ("cacfar", "kstrong"):
        got = tf.polar_to_points(torch.as_tensor(bins), torch.as_tensor(valid),
                                 torch.as_tensor(intens),
                                 torch.as_tensor(peaks), cfg_t, conv)
        want = jf.polar_to_points(jnp.asarray(bins), jnp.asarray(valid),
                                  jnp.asarray(intens), jnp.asarray(peaks),
                                  cfg_j, conv)
        _assert_cloud(got, want)
        rng = np.linalg.norm(got.xy.numpy(), axis=-1).reshape(a, 2)
        offset = 0.0 if conv == "cacfar" else 0.25
        np.testing.assert_allclose(rng, bins * 0.5 + offset, atol=1e-5)
        assert got.valid.numpy().reshape(a, 2)[:, 0].all() == \
            (conv == "cacfar")


def test_intensity_filter_and_add_noise():
    """`intensity_filter` masks as the reference's; `add_noise` moves only
    valid points, by an explicit generator, reproducibly."""
    cfg_j, cfg_t = _cfgs()
    img = np.zeros((64, 256), np.uint8)
    img[0, 100] = 200
    img[1, 40] = 70
    j, t = _pair(img)
    pc_j, pc_t = jf.filter_polar_image(j, cfg_j), tf.filter_polar_image(t, cfg_t)
    for args in ((100.0, 0.0, 60.0), (60.0, 0.0, 30.0), (50.0, 25.0, 150.0)):
        got = tf.intensity_filter(pc_t, *args)
        want = jf.intensity_filter(pc_j, *args)
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_array_equal(got.peak.numpy(), np.asarray(want.peak))
    assert int(tf.intensity_filter(pc_t, 100.0, 0.0, 60.0).valid.sum()) == 1
    noisy = tf.add_noise(pc_t, torch.Generator().manual_seed(0), sigma=0.5)
    again = tf.add_noise(pc_t, torch.Generator().manual_seed(0), sigma=0.5)
    assert torch.equal(noisy.xy, again.xy)
    v = pc_t.valid
    assert torch.equal(noisy.xy[~v], pc_t.xy[~v])
    moved = (noisy.xy[v] - pc_t.xy[v]).norm(dim=-1)
    assert (moved > 0).all() and (moved < 5.0).all()
