"""Share of the LM solve's device time that the least time for its work
would take: the valid packed rows (associations that survive the gates at
the call's radius: twice the configured one on a step's first call) read
once, per call of the `lm_solve` range; the time is all device activity
under that range (`ops/cuda_lm.py` -> `csrc/lm_fused.cu`)."""

from benchmark import roofline

UNIT = "%"
LAYER = "LM kernel (ops/cuda_lm.py, csrc/lm_fused.cu)"
MOVES = "frames_per_s"
SOURCE = "device_trace"
RANGES = ("lm_solve",)


def read(ctx):
    ms = ctx.trace.device_ms(under=RANGES)
    calls = ctx.trace.calls_per_step(RANGES[0])
    if ms <= 0 or not any(calls) or ctx.work is None:
        return None
    w = ctx.work
    rows = sum(int(w["assoc_first" if c == 0 else "assoc"][i].sum())
               for i, n in enumerate(calls) for c in range(n))
    return 100.0 * roofline.lm_bound(rows)["bound_ms"] / ms
