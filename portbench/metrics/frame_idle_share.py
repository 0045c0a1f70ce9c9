"""The device's idle time inside the frames on the host
(``starframe.frame``'s self intervals: a batch's ``frame2_step``, its
array prep, the K4 launch and the restack; the tile engine's
``_run_frame``), as a share (%) of the traced episodes' wall
(``harness/spans.py``)."""

from harness.spans import idle_share


def read(ctx):
    return idle_share(ctx, "starframe.frame")
