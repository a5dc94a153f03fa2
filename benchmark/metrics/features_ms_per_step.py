"""Device time under the `build_normals` range per step: the oriented
surface points (`ops/features.py`)."""

UNIT = "ms/step"
LAYER = "cell features (ops/features.py)"
MOVES = "frames_per_s"
SOURCE = "device_trace"
RANGES = ("build_normals",)


def read(ctx):
    ms = ctx.trace.device_ms(under=RANGES)
    return ms / ctx.steps if ms > 0 else None
