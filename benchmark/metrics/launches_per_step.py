"""Device kernel launches per lockstep step, whatever launched them: the
host dispatch that the batched step (`models/odometry.make_batched_step`)
pays for."""

UNIT = "launches/step"
LAYER = "batched step and host dispatch (models/odometry.py)"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    n = ctx.trace.count(kinds=("kernel",))
    return n / ctx.steps if n else None
