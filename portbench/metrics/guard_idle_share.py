"""The device's idle time inside the staleness guard
(``starframe.guard``'s self intervals: its reductions and the blocking
host read of its verdicts), as a share (%) of the traced episodes' wall
(``harness/spans.py``)."""

from harness.spans import idle_share


def read(ctx):
    return idle_share(ctx, "starframe.guard")
