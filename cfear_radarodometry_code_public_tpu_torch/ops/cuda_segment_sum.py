"""Deterministic segment sum: a CUDA kernel and its plain PyTorch twin
(`jax.ops.segment_sum`'s semantics).

    segment_sum(data (K, ...) f32, ids (K,) int64, n) -> (n, ...) f32

Row r of `data` is added to segment ids[r]; a row whose id lies outside
[0, n) is dropped. Each segment is summed column by column from zero in
ascending row order. Dispatch: the plain twin runs only when the tensors
lie on the CPU; for CUDA tensors the wrapper launches
`csrc/segment_sum.cu` or raises. The kernel is two launches a call: one
lists each segment's rows in row order with integer counts, the other adds
each list. The twin is `index_add_` in torch's deterministic mode (which
adds in row order on the CPU) into one extra row that takes the dropped
rows and is cut away. Both repeat bit for bit and agree bit for bit.

`launches` counts kernel launches, `LAUNCHES_PER_CALL` a call (CPU calls
add nothing); `reset_launches()` zeroes it.
"""

from __future__ import annotations

import contextlib
import math

import torch

#: kernel launches behind one `segment_sum` call (bucket, add)
LAUNCHES_PER_CALL = 2

launches = {"segment_sum": 0}


def reset_launches() -> None:
    launches["segment_sum"] = 0


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


def segment_sum_plain(data, ids, n: int):
    """Plain twin of the kernel, on any device and dtype: deterministic
    `index_add_` into n + 1 rows, the last taking every dropped row (row
    order kept), then cut away."""
    ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    with _deterministic():
        out.index_add_(0, ids, data)
    return out[:n]


def segment_sum(data, ids, n: int):
    """Segment sum (the kernel for CUDA tensors, `segment_sum_plain` on the
    CPU)."""
    if data.dim() < 1 or ids.shape != data.shape[:1]:
        raise ValueError(f"segment_sum: data {tuple(data.shape)} and ids "
                         f"{tuple(ids.shape)} must share their first axis")
    if ids.dtype != torch.int64:
        raise TypeError(f"segment_sum: ids must be int64, got {ids.dtype}")
    if ids.device != data.device:
        raise ValueError(f"segment_sum: ids are on {ids.device}, data on "
                         f"{data.device}")
    if n < 0:
        raise ValueError(f"segment_sum: n={n} must not be negative")
    dev = data.device
    if dev.type == "cpu":
        return segment_sum_plain(data, ids, n)
    if dev.type != "cuda":
        raise RuntimeError(f"segment_sum: no kernel for device {dev}")
    if data.dtype != torch.float32:
        raise TypeError(f"segment_sum: data must be float32, got {data.dtype}")
    from cfear_radarodometry_code_public_tpu_torch.ops import _build
    k = data.shape[0]
    c = math.prod(data.shape[1:])
    out = torch.empty((n,) + tuple(data.shape[1:]), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    data = data.contiguous()
    ids = ids.contiguous()
    # scratch: each segment's end in the row list, and the list
    ends = torch.empty(n, dtype=torch.int32, device=dev)
    keys = torch.empty(max(k, 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().cfear_segment_sum(
            data.data_ptr(), ids.data_ptr(), k, c, n, keys.data_ptr(),
            ends.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment_sum: kernel launch failed with CUDA "
                           f"error {err}")
    launches["segment_sum"] += LAUNCHES_PER_CALL
    return out
