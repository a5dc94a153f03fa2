"""Host syncs a lockstep step: the `sync.*` and `fleet.readback` ranges
that the main thread opened inside the window, over its steps (an exact
count; each range is one wait for the device, `fleet.readback` one a
chunk for all its outputs). A trace with no device activity (a CPU run,
where the plain twin of the LM kernel syncs at every iteration) or with no
such range gives none."""

from benchmark.metrics.idle_upload_ms_per_step import is_sync

UNIT = "syncs/step"
LAYER = "host syncs (sync.* and fleet.readback spans)"
MOVES = "frames_per_s"
SOURCE = "program_span"


def read(ctx):
    tr = ctx.trace
    n = sum(1 for s, e, name in tr.ranges.get(tr.main, ())
            if is_sync(name) and tr.t0 <= s < tr.t1)
    return n / ctx.steps if tr.device and n else None
