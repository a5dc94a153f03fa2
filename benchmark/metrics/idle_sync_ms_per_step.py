"""Device idle time a step that began while the host was blocked in a
sync: the rest of each idle gap, beyond its upload part, that opened while
a `sync.*` or `fleet.readback` range was open on the main thread (the
host reading a value back: `register`'s early stop, the fleet's read-back
of a chunk's outputs, its bootstrap check). The split is
`idle_upload_ms_per_step.split`."""

from benchmark.metrics.idle_upload_ms_per_step import split

UNIT = "ms/step"
LAYER = "host syncs (sync.* and fleet.readback spans)"
MOVES = "frames_per_s"
SOURCE = "program_span"


def read(ctx):
    parts = split(ctx.trace)
    return None if parts is None else parts[1] * 1e-6 / ctx.steps
