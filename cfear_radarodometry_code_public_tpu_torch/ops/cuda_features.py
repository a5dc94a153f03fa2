"""Per-compact-cell feature moments: CUDA kernel G and its plain PyTorch
twin (port of `ops/pallas_features.py`, `moment_accumulate`).

    moment_accumulate(pack (B, R, N), ct_lo, ct_hi (B, c_pre/CT),
                      pt_lo, pt_hi (B, N/PT), offsets_m, n_off, c_pre)
        -> (B, N_MOMENTS, c_pre) f32, rows [cnt, S0, S1x, S1y, Sxx, Sxy,
           Syy, cnt*cx, cnt*cy, 0...] per compact cell, moments about the
           cell's voxel centre

(the pack's row layout is `features._moment_inputs`'s). Dispatch: the plain
twin runs only when the tensors lie on the CPU; for CUDA tensors the
wrapper launches `csrc/moments.cu` or raises. The kernel is two launches a
call: one buckets the (point, offset) hits by cell with integer atomics,
the other sorts each cell's hits and sums them. Both kernel and twin sum
each cell in (point, offset) order with no float atomics, so both repeat
bit for bit and agree bit for bit on the card. Neither reads the x-slab
bounds, which stay in the signature as the reference function has them.

`launches` counts kernel launches, `LAUNCHES_PER_CALL` a call (CPU calls
add nothing); `reset_launches()` zeroes it.
"""

from __future__ import annotations

import torch

#: moment rows in the output (9 used + 7 zero, as the reference)
N_MOMENTS = 16
#: cells per tile of the x-slab skip test
CT = 128
#: points per tile of the x-slab skip test
PT = 512
#: most neighbour offsets the kernel takes ((2 * noff + 1)^2, noff <= 2)
MAX_OFF = 25
#: kernel launches behind one `moment_accumulate` call (fill, sum)
LAUNCHES_PER_CALL = 2

launches = {"moment_accumulate": 0}
_offsets_cache: dict = {}


def reset_launches() -> None:
    launches["moment_accumulate"] = 0


def supported(n_points: int, c_pre: int) -> bool:
    return n_points % PT == 0 and c_pre % CT == 0


def moment_accumulate_plain(pack, ct_lo, ct_hi, pt_lo, pt_hi, offsets_m,
                            n_off: int, c_pre: int):
    """Plain twin of kernel G: every (point, offset) row's 9 moment columns,
    shifted to the target voxel centre, summed per target rank in point
    order by deterministic `index_add_` on every device
    (`cuda_segment_sum.segment_sum_plain`; the slab bounds are not used)."""
    from cfear_radarodometry_code_public_tpu_torch.ops import cuda_segment_sum
    b, _, n = pack.shape
    dev = pack.device
    rx, ry, w, ocx, ocy = (pack[:, i, :, None] for i in range(5))   # (B, N, 1)
    mem = pack[:, 5:5 + n_off].transpose(1, 2)                      # (B, N, n_off)
    trank = pack[:, 5 + n_off:5 + 2 * n_off].transpose(1, 2)
    off = torch.tensor(offsets_m, dtype=torch.float32, device=dev)  # (n_off, 2)
    dxm, dym = off[:, 0], off[:, 1]
    rxt = rx - dxm
    ryt = ry - dym
    wm = w * mem
    wx, wy = wm * rxt, wm * ryt
    data = torch.stack([mem, wm, wx, wy, wx * rxt, wx * ryt, wy * ryt,
                        mem * (ocx + dxm), mem * (ocy + dym)], -1)  # (B, N, n_off, 9)
    lane = torch.arange(b, dtype=torch.int64, device=dev)[:, None, None]
    ids = (lane * c_pre + trank.to(torch.int64)).reshape(-1)
    # rows with no target are dropped (order kept), not summed into an
    # overflow segment: a segment of ~N * n_off rows is summed serially
    keep = (trank < c_pre).reshape(-1)
    acc = cuda_segment_sum.segment_sum_plain(data.reshape(-1, 9)[keep],
                                             ids[keep], b * c_pre)
    out = pack.new_zeros((b, N_MOMENTS, c_pre))
    out[:, :9] = acc.reshape(b, c_pre, 9).transpose(1, 2)
    return out


def _offsets(offsets_m, dev):
    """The (n_off, 2) f32 offsets on `dev`, uploaded once per device."""
    key = (tuple(offsets_m), str(dev))
    t = _offsets_cache.get(key)
    if t is None:
        t = torch.tensor(offsets_m, dtype=torch.float32, device=dev
                         ).contiguous()
        _offsets_cache[key] = t
    return t


def moment_accumulate(pack, ct_lo, ct_hi, pt_lo, pt_hi, offsets_m,
                      n_off: int, c_pre: int):
    """Per-compact-cell moments (kernel G on CUDA, `moment_accumulate_plain`
    on the CPU)."""
    tensors = {"pack": pack, "ct_lo": ct_lo, "ct_hi": ct_hi, "pt_lo": pt_lo,
               "pt_hi": pt_hi}
    dev = pack.device
    for k, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"moment_accumulate: {k} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"moment_accumulate: {k} must be contiguous")
        if t.device != dev:
            raise ValueError(f"moment_accumulate: {k} is on {t.device}, "
                             f"expected {dev}")
    if pack.dim() != 3:
        raise ValueError(f"moment_accumulate: pack must be (B, R, N), got "
                         f"{tuple(pack.shape)}")
    b, r, n = pack.shape
    if not supported(n, c_pre):
        raise ValueError(f"moment_accumulate: N={n} % {PT} and c_pre={c_pre}"
                         f" % {CT} must be 0")
    if len(offsets_m) != n_off or n_off > MAX_OFF or r < 5 + 2 * n_off:
        raise ValueError(f"moment_accumulate: {len(offsets_m)} offsets, "
                         f"n_off={n_off} (at most {MAX_OFF}), {r} pack rows")
    if (ct_lo.shape != (b, c_pre // CT) or ct_hi.shape != ct_lo.shape
            or pt_lo.shape != (b, n // PT) or pt_hi.shape != pt_lo.shape):
        raise ValueError("moment_accumulate: tile bounds shape mismatch")
    if dev.type == "cpu":
        return moment_accumulate_plain(pack, ct_lo, ct_hi, pt_lo, pt_hi,
                                       offsets_m, n_off, c_pre)
    if dev.type != "cuda":
        raise RuntimeError(f"moment_accumulate: no kernel for device {dev}")
    from cfear_radarodometry_code_public_tpu_torch.ops import _build
    out = torch.empty((b, N_MOMENTS, c_pre), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    offs = _offsets(offsets_m, dev)
    # scratch: each cell's end in its lane's key list, and the keys
    ends = torch.empty((b, c_pre), dtype=torch.int32, device=dev)
    keys = torch.empty((b, n_off * n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().cfear_moment_accumulate(
            pack.data_ptr(), offs.data_ptr(), b, r, n, n_off, c_pre,
            ends.data_ptr(), keys.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"moment_accumulate: kernel launch failed with "
                           f"CUDA error {err}")
    launches["moment_accumulate"] += LAUNCHES_PER_CALL
    return out
