"""Device time under `register` but under neither `associate` nor
`lm_solve`, per step: registration's own work (the outer loop, the cost,
gradient and Hessian, the covariance; `ops/registration.py`)."""

UNIT = "ms/step"
LAYER = "registration (ops/registration.py)"
MOVES = "frames_per_s"
SOURCE = "device_trace"
RANGES = ("register",)
CHILDREN = ("associate", "lm_solve")


def read(ctx):
    ms = ctx.trace.device_ms(under=RANGES, minus=CHILDREN)
    return ms / ctx.steps if ms > 0 else None
