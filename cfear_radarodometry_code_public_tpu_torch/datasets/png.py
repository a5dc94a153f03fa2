"""PNG files of radar sweeps, read and written with numpy and `zlib` alone.

The released Oxford Radar RobotCar and MulRan sweeps are PNGs of 8-bit
samples: greyscale, or an RGB / RGBA form whose first channel the loaders
take (`oxford.oxford_frames`). `read_png` decodes exactly that: bit depth 8,
colour types 0 (grey), 2 (RGB) and 6 (RGBA), no interlace, the five
scanline filters of the PNG specification (None, Sub, Up, Average, Paeth),
with each chunk's CRC checked. Anything else raises
`PNGError`; it never answers with other pixels. `write_png` is the matching
minimal encoder (one IDAT chunk, a scanline filter chosen per row), which
writes the dataset layouts from the simulator.

Average and Paeth depend on the reconstructed pixel to the left and the
rows above, so `read_png` reconstructs the image along its anti-diagonals:
in skewed coordinates (row r, column r + x) a pixel's left, upper and
upper-left neighbours all lie in the two columns before it, and one step
handles every row at once. The arithmetic is in int16, where the Paeth
predictor's differences and the Average's sum cannot wrap.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}    # colour type -> samples a pixel


class PNGError(ValueError):
    """A PNG file that `read_png` does not decode."""


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRC checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise PNGError(f"{path}: not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise PNGError(f"{path}: chunk {kind!r} is truncated or its CRC "
                           "does not match")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PNGError(f"{path}: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, ftype: np.ndarray, width: int,
              bpp: int) -> np.ndarray:
    """Reconstruct (H, width * bpp) uint8 samples from the filtered rows
    (H, width * bpp) and each row's filter type (H,)."""
    h = rows.shape[0]
    f = rows.reshape(h, width, bpp).astype(np.int16)
    if not (ftype >= 3).any():
        # None, Sub and Up: a row at a time, Sub as a running sum mod 256
        out = np.zeros((h + 1, width, bpp), np.uint8)
        for r in range(h):
            row = f[r].astype(np.uint8)
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif ftype[r] == 2:
                row = row + out[r]
            out[r + 1] = row
        return out[1:].reshape(h, width * bpp)
    diag = width + h - 1
    # skewed: sk[r + 1, 2 + r + x] is pixel (r, x); row 0 and the two
    # columns before every row's first pixel stay 0 (the PNG's outside)
    sk = np.zeros((h + 1, diag + 2, bpp), np.int16)
    fs = np.zeros((h, diag, bpp), np.int16)
    r_idx = np.arange(h)[:, None]
    fs[r_idx, r_idx + np.arange(width)[None]] = f
    kind = [(ftype == k)[:, None] for k in range(5)]
    for d in range(diag):
        r0, r1 = max(0, d - width + 1), min(h, d + 1)
        a = sk[r0 + 1:r1 + 1, d + 1]            # left
        b = sk[r0:r1, d + 1]                    # up
        c = sk[r0:r1, d]                        # upper left
        k = [m[r0:r1] for m in kind]
        pred = np.where(k[1], a, 0) + np.where(k[2], b, 0) \
            + np.where(k[3], (a + b) >> 1, 0) \
            + np.where(k[4], _paeth(a, b, c), 0)
        sk[r0 + 1:r1 + 1, d + 2] = (fs[r0:r1, d] + pred) & 0xFF
    out = sk[1 + r_idx, 2 + r_idx + np.arange(width)[None]]
    return out.astype(np.uint8).reshape(h, width * bpp)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The pixels of PNG bytes: (H, W) uint8 for greyscale, (H, W, 3) for
    RGB and (H, W, 4) for RGBA, as `np.asarray(PIL.Image.open(...))` gives
    them. Raises PNGError for any form outside the module's list."""
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            raise PNGError(f"{path}: palette images are not read")
    if header is None or not idat:
        raise PNGError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, colour, compression, filt, interlace = header
    if depth != 8 or colour not in CHANNELS:
        raise PNGError(f"{path}: bit depth {depth}, colour type {colour}; "
                       "only 8-bit grey, RGB and RGBA are read")
    if compression or filt or interlace:
        raise PNGError(f"{path}: compression {compression}, filter method "
                       f"{filt}, interlace {interlace}; only 0, 0, 0 are read")
    bpp = CHANNELS[colour]
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{path}: image data does not inflate: {e}") from e
    if len(raw) != height * (stride + 1):
        raise PNGError(f"{path}: {len(raw)} bytes of image data, expected "
                       f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise PNGError(f"{path}: scanline filter type {int(ftype.max())}")
    img = _unfilter(rows[:, 1:], ftype, width, bpp)
    return img.reshape((height, width) if bpp == 1 else (height, width, bpp))


def read_png(path: str) -> np.ndarray:
    """`decode_png` of the file at `path`."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _filter_rows(img: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """The PNG scanlines of (H, W * bpp) uint8 samples, each row with its
    filter type byte first."""
    x = img.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1,
                     _paeth(left, up, upleft)])
    t = ftype.astype(np.int64)
    filtered = (x - pred[t, np.arange(len(t))]) & 0xFF
    return np.concatenate([ftype[:, None].astype(np.uint8),
                           filtered.astype(np.uint8)], 1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray, filters=2) -> bytes:
    """PNG bytes of (H, W) uint8 greyscale or (H, W, C) uint8 with C 3 or
    4. `filters` is one filter type (0-4) for every row or a sequence of
    one a row (repeated over the rows)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise PNGError(f"write_png takes uint8 (H, W[, C]), got {img.dtype} "
                       f"{img.shape}")
    bpp = 1 if img.ndim == 2 else img.shape[2]
    colour = {v: k for k, v in CHANNELS.items()}.get(bpp)
    if colour is None:
        raise PNGError(f"write_png takes 1, 3 or 4 channels, got {bpp}")
    h, w = img.shape[:2]
    ftype = np.resize(np.asarray(filters, np.uint8).reshape(-1), h)
    if (ftype > 4).any():
        raise PNGError(f"scanline filter types are 0-4, got {filters}")
    rows = _filter_rows(img.reshape(h, w * bpp), ftype, bpp)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filters=2) -> None:
    """`encode_png(img, filters)` into the file at `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))
