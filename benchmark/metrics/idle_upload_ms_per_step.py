"""Device idle time a step that opened or lasted while the host uploaded a
chunk: the part of each idle gap that the main thread spent inside a
`fleet.upload` range (`MultiSequenceRunner.process`: the host's pinned copy
of a chunk of raw sweeps and the enqueue of its copy to the card).

`split` is the one split of the idle time that the three `idle_*` metrics
read, a gap at a time: the part of a gap inside `fleet.upload` is upload
idle; the rest is sync idle if the gap began while a `sync.*` or
`fleet.readback` range was open (the host was blocked reading a value back
when the device ran dry), else dispatch idle (the host was still queueing
work). The three add up to the whole idle time of the window. A trace
with no device activity (a CPU run) or without the program's
`fleet.upload` ranges gives none."""

import bisect

UNIT = "ms/step"
LAYER = "fleet runner (parallel/mesh.py over models/odometry.upload_images)"
MOVES = "frames_per_s"
SOURCE = "program_span"
UPLOAD = "fleet.upload"


def is_sync(name: str) -> bool:
    return name.startswith("sync.") or name == "fleet.readback"


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def split(tr):
    """(upload, sync, dispatch) idle ns of the window, or None."""
    rs = tr.ranges.get(tr.main, ())
    uploads = _union((s, e) for s, e, n in rs if n == UPLOAD)
    if not tr.device or not uploads:
        return None
    syncs = _union((s, e) for s, e, n in rs if is_sync(n))
    sync_starts = [s for s, _ in syncs]
    edges = [tr.t0] + [x for iv in tr.busy_intervals() for x in iv] + [tr.t1]
    up = sy = di = 0
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        u = sum(max(0, min(g1, e) - max(g0, s)) for s, e in uploads)
        i = bisect.bisect_right(sync_starts, g0) - 1
        if i >= 0 and syncs[i][1] > g0:
            sy += g1 - g0 - u
        else:
            di += g1 - g0 - u
        up += u
    return up, sy, di


def read(ctx):
    parts = split(ctx.trace)
    return None if parts is None else parts[0] * 1e-6 / ctx.steps
