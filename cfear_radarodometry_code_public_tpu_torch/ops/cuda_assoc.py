"""Exact 1-NN association: CUDA kernels and their plain PyTorch twins
(port of `ops/pallas_assoc.py`, kernels A `nn_min` and C `nn_min_sparse`).

Every function takes a leading lane axis, so one launch serves a batched
step: src (B, Msrc, 2), tar (B, S, M, 2), valid (B, S, M) ->
nn (B, S, Msrc) int32, d2 (B, S, Msrc) float32.

Dispatch: `nn_min` / `nn_min_sparse` run their plain twin only when the
tensors lie on the CPU. For CUDA tensors they launch the kernel of
`csrc/nn_assoc.cu` or raise; there is no fallback. The kernels and the twins
agree bit for bit (same difference form, no FMA contraction, lowest-index
argmin on ties).

`launches` counts kernel launches per kernel (CPU calls add nothing);
`reset_launches()` zeroes it.
"""

from __future__ import annotations

import torch

TS_SPARSE = 256      # source rows per skip-test granule (kernel C)
TT_SPARSE = 512      # target rows per skip-test granule (kernel C)
_TS = 256            # cell-budget granule of the dense kernel's policy

launches = {"nn_min": 0, "nn_min_sparse": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supported(m: int) -> bool:
    """Same policy as the reference: the cell budget tiles evenly."""
    return m % _TS == 0


def supported_sparse(m_src: int, m_tar: int) -> bool:
    return m_src % TS_SPARSE == 0 and m_tar % TT_SPARSE == 0


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


def _pair_live(src_bounds, tar_bounds, radius):
    """(B, S, Msrc/TS, M/TT) bool: the tile pair's bbox gap is within the
    radius (the kernel's per-block skip test, in the same f32 arithmetic)."""
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
    """Plain twin of kernel C: kernel A restricted to tile pairs that pass
    the bbox gap test; rows with no unskipped valid target report
    (+inf, 0). Equal to A on every row whose true 1-NN is within the
    radius; other rows report d2 >= radius^2."""
    live = _pair_live(src_bounds, tar_bounds, radius)
    live = live.repeat_interleave(TS_SPARSE, 2).repeat_interleave(TT_SPARSE, 3)
    d2 = torch.where(live, _d2_dense(src, tar, valid),
                     src.new_full((), float("inf")))
    return torch.argmin(d2, dim=-1).to(torch.int32), d2.amin(-1)


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
    return dev


def _check_shapes(name, src, tar, valid):
    if src.dim() != 3 or src.shape[-1] != 2:
        raise ValueError(f"{name}: src must be (B, Msrc, 2), got {tuple(src.shape)}")
    b, s, m = valid.shape
    if tar.shape != (b, s, m, 2) or src.shape[0] != b:
        raise ValueError(f"{name}: shapes src {tuple(src.shape)}, tar "
                         f"{tuple(tar.shape)}, valid {tuple(valid.shape)} "
                         "do not match (B, Msrc, 2), (B, S, M, 2), (B, S, M)")


def _raise_on(name, err: int):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def nn_min(src, tar, valid):
    """Exact 1-NN of each source point among each keyframe's targets
    (kernel A on CUDA, `nn_min_plain` on the CPU)."""
    dev = _check("nn_min", src=src, tar=tar, valid=valid)
    _check_shapes("nn_min", src, tar, valid)
    if dev.type == "cpu":
        return nn_min_plain(src, tar, valid)
    if dev.type != "cuda":
        raise RuntimeError(f"nn_min: no kernel for device {dev}")
    from cfear_radarodometry_code_public_tpu_torch.ops import _build
    b, s, m = valid.shape
    m_src = src.shape[1]
    nn = torch.empty((b, s, m_src), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, s, m_src), dtype=torch.float32, device=dev)
    if nn.numel() == 0:
        return nn, d2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().cfear_nn_min(
            src.data_ptr(), tar.data_ptr(), valid.data_ptr(), b, s, m_src, m,
            nn.data_ptr(), d2.data_ptr(), stream)
    _raise_on("nn_min", err)
    launches["nn_min"] += 1
    return nn, d2


def nn_min_sparse(src, src_bounds, tar, tar_bounds, valid, radius):
    """Block-sparse exact 1-NN within `radius` (B,) per keyframe (kernel C
    on CUDA, `nn_min_sparse_plain` on the CPU). src_bounds
    (B, Msrc/256, 4), tar_bounds (B, S, M/512, 4) from `tile_bounds`."""
    dev = _check("nn_min_sparse", src=src, src_bounds=src_bounds, tar=tar,
                 tar_bounds=tar_bounds, valid=valid, radius=radius)
    _check_shapes("nn_min_sparse", src, tar, valid)
    b, s, m = valid.shape
    m_src = src.shape[1]
    if not supported_sparse(m_src, m):
        raise ValueError(
            f"nn_min_sparse: m_src={m_src} % {TS_SPARSE} and m_tar={m} % "
            f"{TT_SPARSE} must both be 0")
    if (src_bounds.shape != (b, m_src // TS_SPARSE, 4)
            or tar_bounds.shape != (b, s, m // TT_SPARSE, 4)
            or radius.shape != (b,)):
        raise ValueError("nn_min_sparse: bounds or radius shape mismatch")
    if dev.type == "cpu":
        return nn_min_sparse_plain(src, src_bounds, tar, tar_bounds, valid,
                                   radius)
    if dev.type != "cuda":
        raise RuntimeError(f"nn_min_sparse: no kernel for device {dev}")
    from cfear_radarodometry_code_public_tpu_torch.ops import _build
    nn = torch.empty((b, s, m_src), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, s, m_src), dtype=torch.float32, device=dev)
    if nn.numel() == 0:
        return nn, d2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().cfear_nn_min_sparse(
            src.data_ptr(), src_bounds.data_ptr(), tar.data_ptr(),
            tar_bounds.data_ptr(), valid.data_ptr(), radius.data_ptr(),
            b, s, m_src, m, nn.data_ptr(), d2.data_ptr(), stream)
    _raise_on("nn_min_sparse", err)
    launches["nn_min_sparse"] += 1
    return nn, d2
