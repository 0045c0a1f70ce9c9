"""The device's idle time inside the program's joint work outside the
frame kernel (``starframe.joints``' self intervals: a jointed batch's
joint slots, once a call, and each frame's joint preparation), as a share
(%) of the traced episodes' wall (``harness/spans.py``). None where the
window holds no such span: a batch without joints, or a program that does
not record it."""

from harness import spans

NAME = "starframe.joints"


def read(ctx):
    t = ctx.trace
    r = None if t is None or t["busy_s"] <= 0 else spans.reduce(t)
    if r is None or NAME not in r["counts"]:
        return None
    return 100.0 * r["idle_s"].get(NAME, 0.0) / t["window_s"]
