"""Share of the association's device time that the least time for its work
would take: one distance per (valid source cell, valid target cell of a
valid keyframe) pair of each lane, per call of the `associate` range; the
time is all device activity under that range, whatever the kernel
(`ops/cuda_assoc.py` -> `csrc/nn_assoc.cu`)."""

from benchmark import roofline

UNIT = "%"
LAYER = "association kernels (ops/cuda_assoc.py, csrc/nn_assoc.cu)"
MOVES = "frames_per_s"
SOURCE = "device_trace"
RANGES = ("associate",)


def read(ctx):
    ms = ctx.trace.device_ms(under=RANGES)
    calls = ctx.trace.calls_per_step(RANGES[0])
    if ms <= 0 or not any(calls) or ctx.work is None:
        return None
    w = ctx.work
    works = [roofline.assoc_work(int(w["n_src"][i, j]), int(w["n_tar"][i, j]),
                                 int(w["n_kf"][i, j]))
             for i, n in enumerate(calls) for _ in range(n)
             for j in range(w["n_src"].shape[1])]
    return 100.0 * roofline.assoc_bound(works)["bound_ms"] / ms
