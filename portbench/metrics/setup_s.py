"""Process start to the first timed call: imports, the scene from the
seed, the traffic's settling frames, the kernel build or load and the
warm-up episode (the result's ``setup`` key splits it in phases and gives
the build's share)."""


def read(ctx):
    return ctx.setup_s
