"""The least time an NVIDIA H100 could take for a layer's work, and the
work that a step's inputs need.

`bound` is a frozen copy of `chip_smoke.bound` at commit
292d3f4b1f62e4192f42d57c14b23d20a72934ff (with `HBM_BYTES_PER_S`,
`F32_FLOPS_PER_S` and `NN_FLOPS` beside it), kept here so that the yardstick
cannot change with the program: the larger of the bytes (each input read
once, each output written once) over the memory rate and the operations
over the float32 rate outside the tensor cores, from NVIDIA's H100 SXM data
sheet, both at the 700 W power limit.

The counts are the work the inputs need, never what an implementation does:
for the association, one distance per (valid source cell, valid target cell
of a valid keyframe) pair per call; for the LM solve, the valid packed rows
(an association that survived the gates), each read once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# operations of one squared distance and its running minimum (2 subtracts,
# 2 multiply-adds counted as 2 operations each would be 6; the smoke counts
# dx, dy, dx*dx + dy*dy as 4 and the compare as 1)
NN_FLOPS = 5
# one packed LM row: [sx, sy, mx, my, w, l11, l21, l22] float32
LM_ROW_BYTES = 8 * 4


def bound(nbytes: float, flops: float) -> dict:
    """`bound_ms` and `bound_by` of a kernel call from its bytes and
    operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def assoc_work(n_src: int, n_tar: int, n_kf: int) -> dict:
    """One lane of one association call: `n_src` valid source cells,
    `n_tar` valid target cells over `n_kf` valid keyframes. Bytes: the
    source means read (8 bytes a cell), the target means and flags read
    (9 bytes a cell), an index and a distance written per (keyframe,
    source cell) (8 bytes)."""
    return {"distances": n_src * n_tar,
            "bytes": n_src * 8 + n_tar * 9 + n_kf * n_src * 8}


def assoc_bound(works) -> dict:
    """The bound of association calls from their lanes' `assoc_work`."""
    works = list(works)
    return {**bound(sum(w["bytes"] for w in works),
                    NN_FLOPS * sum(w["distances"] for w in works)),
            "distances": sum(w["distances"] for w in works)}


def lm_bound(valid_rows: int) -> dict:
    """The bound of LM solves over `valid_rows` valid packed rows in all."""
    return {**bound(valid_rows * LM_ROW_BYTES, 0.0), "rows": valid_rows}
