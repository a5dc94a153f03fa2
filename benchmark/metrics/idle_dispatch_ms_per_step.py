"""Device idle time a step that began while the host was neither uploading
nor blocked in a sync: the device ran dry while the host was still
queueing the step's launches (Python and dispatch slower than the
kernels). The split is `idle_upload_ms_per_step.split`."""

from benchmark.metrics.idle_upload_ms_per_step import split

UNIT = "ms/step"
LAYER = "batched step and host dispatch (models/odometry.py)"
MOVES = "frames_per_s"
SOURCE = "program_span"


def read(ctx):
    parts = split(ctx.trace)
    return None if parts is None else parts[2] * 1e-6 / ctx.steps
