"""Share of the traced window in which no kernel, copy or fill ran on the
device."""

UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
