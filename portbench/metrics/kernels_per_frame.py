"""Device kernels launched a frame over the traced episodes (copies and
sets not counted)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t["frames"]:
        return None
    n = sum(1 for d in t["dev"] if d[1] == "kernel")
    return n / t["frames"] if n else None
