"""Device time under the `features.moments` range per step: stage 2 of the
cell features, the neighbourhood, membership and the 63-column moment
scatter (`segment_sum`: on the card the segment-sum kernel,
`csrc/segment_sum.cu`, which never reads a row whose id lies past the last
segment), or kernel G with its inputs (`ops/features.py`)."""

UNIT = "ms/step"
LAYER = "cell features (ops/features.py)"
MOVES = "frames_per_s"
SOURCE = "device_trace"
RANGES = ("features.moments",)


def read(ctx):
    ms = ctx.trace.device_ms(under=RANGES)
    return ms / ctx.steps if ms > 0 else None
