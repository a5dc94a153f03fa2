"""Frames a second over the untraced window of a traced run: the cell's
`frames_per_s`, read per layer where the host's dispatch paces the step and
the rate swings too far from run to run to hold a bound (the harness runs
the window before the traced chunks because this reader sets `WINDOW`).
`MOVES` names the end-to-end metric that such a cell reports: the rate
itself is bounded in no cell where it is read this way."""

UNIT = "frames/s"
LAYER = "batched step and host dispatch (models/odometry.py)"
MOVES = "memory_peak_gib"
SOURCE = "host_clock"
WINDOW = True


def read(ctx):
    w = ctx.window
    if not w or w["seconds"] <= 0:
        return None
    return w["frames"] / w["seconds"]
