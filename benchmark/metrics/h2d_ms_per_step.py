"""Device time of host-to-device copies per lockstep step: the fleet
runner's upload of each chunk of raw sweeps (`MultiSequenceRunner.process`
-> `models/odometry.upload_images`)."""

UNIT = "ms/step"
LAYER = "fleet runner (parallel/mesh.py over models/odometry.upload_images)"
MOVES = "frames_per_s"
SOURCE = "device_trace"


def read(ctx):
    ms = ctx.trace.device_ms(kinds=("gpu_memcpy",), name_has="HtoD")
    return ms / ctx.steps if ms > 0 else None
