"""The port's PNG codec (`datasets/png.py`, numpy and zlib) against PIL.

The port's dataset loaders decode the released Oxford and MulRan sweeps
with `png.read_png`, where the reference uses PIL. Held bit for bit: the
decoder against PIL on greyscale, RGB and RGBA images that
use each of the five scanline filters and all five mixed row by row (from
the port's encoder), on files PIL's own encoder writes (its adaptive
filters), and on the output of both dataset fixture writers (the
reference tests' PIL writers of `tests/test_e2e_golden.py` and
`tests/test_e2e_golden_mulran.py`, and `chip_smoke.write_dataset`, whose
files PIL must read back to the rendered sweeps). Forms outside the codec's
list raise `PNGError`.
"""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from cfear_radarodometry_code_public_tpu_torch.datasets import oxford, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402
sys.path.remove(REPO)

SHAPES = {"grey": (37, 29), "rgb": (23, 17, 3), "rgba": (13, 19, 4)}
FILTERS = [0, 1, 2, 3, 4, [0, 1, 2, 3, 4]]


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _image(shape, seed=0):
    """Noise over smooth ramps: small and large differences in every
    direction, and samples near 0 and 255, where the filters' sums wrap."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    ramp = (np.arange(h)[:, None] * 7 + np.arange(w)[None] * 13) % 256
    if len(shape) == 3:
        ramp = ramp[..., None] + 61 * np.arange(shape[2])
    noise = rng.integers(-40, 41, shape)
    img = (ramp + noise) % 256
    img[0, 0] = 255
    img[-1, -1] = 0
    return img.astype(np.uint8)


@pytest.mark.parametrize("filters", FILTERS, ids=str)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_decoder_equals_pil_on_every_filter(kind, filters):
    """The port's encoder with one filter type for every row (or all five
    in turn): PIL and the port's decoder both read the image back."""
    img = _image(SHAPES[kind])
    data = png.encode_png(img, filters)
    rows = np.frombuffer(zlib.decompress(data[8 + 25 + 8:-12 - 4]),
                         np.uint8).reshape(img.shape[0], -1)
    want = np.resize(np.asarray(filters).reshape(-1), img.shape[0])
    np.testing.assert_array_equal(rows[:, 0], want)
    np.testing.assert_array_equal(_pil(data), img)
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba"])
def test_decoder_reads_pils_files(kind):
    """Files written by PIL's encoder, whose adaptive filter choice mixes
    the five filters: the port's decoder gives PIL's pixels."""
    img = _image(SHAPES[kind], seed=1)
    big = np.concatenate([img] * 8, 1)
    for a in (img, big, np.zeros_like(img), np.full_like(img, 255)):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="PNG")
        np.testing.assert_array_equal(png.decode_png(buf.getvalue()),
                                      _pil(buf.getvalue()))


def test_decoder_refuses_what_it_does_not_read(tmp_path):
    """16-bit samples, palettes, grey + alpha, interlace, an unknown filter
    type, a damaged CRC and truncated data raise PNGError."""
    img = _image((5, 6))
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint16) * 200).save(buf, format="PNG")
    with pytest.raises(png.PNGError, match="bit depth 16"):
        png.decode_png(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(img).convert("P").save(buf, format="PNG")
    with pytest.raises(png.PNGError, match="palette"):
        png.decode_png(buf.getvalue())
    good = png.encode_png(img, 0)

    def with_header(**kw):
        w, h, depth, colour, comp, filt, inter = struct.unpack(
            ">IIBBBBB", good[16:29])
        vals = {"depth": depth, "colour": colour, "interlace": inter, **kw}
        body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["colour"],
                           comp, filt, vals["interlace"])
        return (good[:8] + png._chunk(b"IHDR", body) + good[33:])

    with pytest.raises(png.PNGError, match="interlace 1"):
        png.decode_png(with_header(interlace=1))
    with pytest.raises(png.PNGError, match="colour type 3"):
        png.decode_png(with_header(colour=3))
    buf = io.BytesIO()
    Image.fromarray(img).convert("LA").save(buf, format="PNG")
    with pytest.raises(png.PNGError, match="colour type 4"):
        png.decode_png(buf.getvalue())
    rows = bytearray(zlib.decompress(good[41:-16]))
    rows[0] = 5
    bad = (good[:33] + png._chunk(b"IDAT", zlib.compress(bytes(rows)))
           + good[-12:])
    with pytest.raises(png.PNGError, match="filter type 5"):
        png.decode_png(bad)
    damaged = bytearray(good)
    damaged[45] ^= 0xFF
    with pytest.raises(png.PNGError, match="CRC"):
        png.decode_png(bytes(damaged))
    with pytest.raises(png.PNGError, match="no IEND"):
        png.decode_png(good[:-12])
    with pytest.raises(png.PNGError, match="signature"):
        png.decode_png(b"GIF89a" + good[6:])
    path = tmp_path / "x.png"
    png.write_png(str(path), img, [4, 3])
    np.testing.assert_array_equal(png.read_png(str(path)), img)


@pytest.mark.parametrize("dataset", ["oxford", "mulran"])
def test_decoder_on_the_reference_fixture_writers(dataset, tmp_path):
    """Every sweep that the reference tests' fixture writers save with PIL
    (`_write_oxford_fixture`, `_write_mulran_fixture`: full sensor scale)
    decodes to PIL's pixels, and the port's loader gives the reference
    loader's frames and stamps."""
    from cfear_radarodometry_code_public_tpu.datasets import oxford as jox
    if dataset == "oxford":
        from test_e2e_golden import _write_oxford_fixture as write
        frames = "oxford_frames"
    else:
        from test_e2e_golden_mulran import _write_mulran_fixture as write
        frames = "mulran_frames"
    radar_dir, _, _ = write(str(tmp_path))
    names = sorted(os.listdir(radar_dir))
    assert len(names) == 12
    for name in names[:3]:
        path = os.path.join(radar_dir, name)
        np.testing.assert_array_equal(png.read_png(path),
                                      np.asarray(Image.open(path)))
    for (t, a), (u, b) in zip(getattr(oxford, frames)(radar_dir),
                              getattr(jox, frames)(radar_dir)):
        assert t == u
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset", ["oxford", "mulran"])
def test_chip_smoke_dataset_writer(dataset, tmp_path, monkeypatch):
    """`chip_smoke.write_dataset` (the `cli-oxford` and `cli-mulran` paths'
    inputs, cut to 3 sweeps here): PIL reads each file as written (the
    Oxford sweep behind its 11 zero metadata columns, the MulRan sweep
    range-major), and the port's and the reference's loaders both give the
    rendered sweeps back with the same stamps."""
    from cfear_radarodometry_code_public_tpu.datasets import oxford as jox
    seq = {**chip_smoke.DATASET_SEQUENCES[dataset], "n_frames": 3}
    monkeypatch.setitem(chip_smoke.DATASET_SEQUENCES, dataset, seq)
    images = chip_smoke.write_dataset(dataset, str(tmp_path))
    sub = "radar" if dataset == "oxford" else "polar"
    names = sorted(os.listdir(tmp_path / sub))
    assert len(names) == len(images) == 3
    for name, img in zip(names, images):
        stored = np.asarray(Image.open(tmp_path / sub / name))
        if dataset == "oxford":
            assert stored.shape == (400, 11 + 3768)
            assert not stored[:, :11].any()
            np.testing.assert_array_equal(stored[:, 11:], img)
        else:
            assert stored.shape == (3360, 400)
            np.testing.assert_array_equal(oxford.rotate_90_ccw(stored), img)
    frames = f"{dataset}_frames"
    got = list(getattr(oxford, frames)(str(tmp_path / sub)))
    want = list(getattr(jox, frames)(str(tmp_path / sub)))
    for (t, a), (u, b), img in zip(got, want, images):
        assert t == u
        np.testing.assert_array_equal(a, img)
        np.testing.assert_array_equal(b, img)
    stamps, poses = oxford.load_gt_csv(str(tmp_path / "gt.csv"))
    assert len(poses) == 4 and stamps[0] < got[0][0] < stamps[-1]
