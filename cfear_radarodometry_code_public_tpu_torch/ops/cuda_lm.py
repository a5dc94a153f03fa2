"""The whole LM solve as one CUDA kernel, and its plain PyTorch twin (port
of the kernel half of `ops/pallas_lm.py`: `lm_solve_fused`, kernel F).

    lm_solve_fused(packed (B, 8, N) f32, pose0 (B, 3) f32, cfg)
        -> pose (B, 3), cost (B,), steps (B,) int32, last_rel (B,)

Dispatch: the plain twin runs only when the tensors lie on the CPU. For
CUDA tensors the wrapper launches `csrc/lm_fused.cu` on the current stream
or raises; there is no fallback. A lane is a thread-block cluster of 1, 8
or 16 CTAs, chosen from N alone, that holds the lane's rows in shared
memory for the whole solve, so a lane's result does not depend on B.
`early_exit=True` is
the reference's `_lm_kernel_ee` (the loop breaks once the lane is done),
False its masked `_lm_kernel` (always `max_itr_solver` iterations, the
converged state frozen); both give the same result.

`launches` counts kernel launches (CPU calls add nothing);
`reset_launches()` zeroes it.
"""

from __future__ import annotations

import torch

COSTS = {"P2P": 0, "P2L": 1, "P2D": 2}
LOSSES = {"None": 0, "Huber": 1, "Cauchy": 2, "SoftLOne": 3, "Tukey": 4,
          "Combined": 5, "DCS": 6}
OUT_COLS = 6   # [px, py, pt, cost, steps (int32 bits), last_rel]

launches = {"lm_solve_fused": 0}


def reset_launches() -> None:
    launches["lm_solve_fused"] = 0


def lm_solve_fused_plain(packed, pose0, cfg, early_exit: bool = True):
    """Plain twin of kernel F: the masked loop of `lm._lm_core` (the
    reference's `bounded` form). It stops once every lane is done, which
    gives the same result for both `early_exit` values."""
    from cfear_radarodometry_code_public_tpu_torch.ops import lm
    rows = tuple(packed[:, i] for i in range(8))
    px, py, pt, cost, steps, lastrel = lm._lm_core(
        rows, pose0[:, 0], pose0[:, 1], pose0[:, 2], cfg)
    return torch.stack([px, py, pt], -1), cost, steps, lastrel


def _check(packed, pose0):
    for name, t in (("packed", packed), ("pose0", pose0)):
        if t.dtype != torch.float32:
            raise TypeError(f"lm_solve_fused: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lm_solve_fused: {name} must be contiguous")
    if pose0.device != packed.device:
        raise ValueError(f"lm_solve_fused: pose0 is on {pose0.device}, "
                         f"expected {packed.device}")
    if packed.dim() != 3 or packed.shape[1] != 8:
        raise ValueError("lm_solve_fused: packed must be (B, 8, N), got "
                         f"{tuple(packed.shape)}")
    if pose0.shape != (packed.shape[0], 3):
        raise ValueError(f"lm_solve_fused: pose0 must be ({packed.shape[0]}, "
                         f"3), got {tuple(pose0.shape)}")


def lm_solve_fused(packed, pose0, cfg, early_exit: bool = True):
    """The trust-region LM over packed rows (kernel F on CUDA,
    `lm_solve_fused_plain` on the CPU)."""
    _check(packed, pose0)
    reg = cfg.registration
    if reg.cost not in COSTS or reg.loss not in LOSSES:
        raise ValueError(f"lm_solve_fused: unknown cost '{reg.cost}' or loss "
                         f"'{reg.loss}'")
    dev = packed.device
    if dev.type == "cpu":
        return lm_solve_fused_plain(packed, pose0, cfg, early_exit)
    if dev.type != "cuda":
        raise RuntimeError(f"lm_solve_fused: no kernel for device {dev}")
    return _launch(packed, pose0, cfg, early_exit)


def _launch(packed, pose0, cfg, early_exit: bool = True, cluster: int = 0,
            smem_rows: int = 0):
    """Launch kernel F on checked CUDA tensors. `cluster` and `smem_rows`
    are 0 for the kernel's own choice from N, and no code of the port may
    pass anything else (`tests/test_torch_lm.py` searches the package for
    it): only measurements and tests force a cluster size (1, 2, 4, 8, 16)
    or the rows a CTA keeps in shared memory. A launch the card refuses
    raises."""
    from cfear_radarodometry_code_public_tpu_torch.ops import _build
    reg = cfg.registration
    dev = packed.device
    b, _, n = packed.shape
    out = torch.empty((b, OUT_COLS), dtype=torch.float32, device=dev)
    if b:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _build.library().cfear_lm_solve_fused(
                packed.data_ptr(), pose0.data_ptr(), b, n, COSTS[reg.cost],
                LOSSES[reg.loss], reg.loss_limit, reg.max_itr_solver,
                reg.function_tolerance, int(early_exit), cluster, smem_rows,
                out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"lm_solve_fused: kernel launch failed with "
                               f"CUDA error {err}")
        launches["lm_solve_fused"] += 1
    return out[:, :3], out[:, 3], out[:, 4].view(torch.int32), out[:, 5]
