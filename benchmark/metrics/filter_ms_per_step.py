"""Device time under the `Filtering` and `compensate` ranges per step: the
image filter and motion compensation (`ops/filtering.py`)."""

UNIT = "ms/step"
LAYER = "image filter and compensation (ops/filtering.py)"
MOVES = "frames_per_s"
SOURCE = "device_trace"
RANGES = ("Filtering", "compensate")


def read(ctx):
    ms = ctx.trace.device_ms(under=RANGES)
    return ms / ctx.steps if ms > 0 else None
