"""Share of the rows that the feature stage scatters which land in a voxel
of the grid: 100 x `features.points_in_grid` / `features.points`, the
program's counters over the traced window (`ops/features.py`
`_voxel_centroids`). Every other row (an invalid point, or one off the
grid) gets an id past the last segment, and the segment sum never reads
it. A trace with no device activity (a CPU run) or a program without the
counters gives none."""

UNIT = "%"
LAYER = "cell features (ops/features.py)"
MOVES = "frames_per_s"
SOURCE = "program_counter"


def read(ctx):
    if not ctx.trace.device:
        return None
    try:
        from cfear_radarodometry_code_public_tpu_torch.utils import trace
    except ImportError:
        return None
    c = trace.counters()
    if not c.get("features.points"):
        return None
    return 100.0 * c.get("features.points_in_grid", 0) / c["features.points"]
