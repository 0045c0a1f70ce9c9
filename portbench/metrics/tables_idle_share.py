"""The device's idle time inside the program's table builds
(``starframe.tables``' self intervals: K2 and its host prep with the
budget's scatter in a batch; K5 and its counters on the tile engine), as
a share (%) of the traced episodes' wall (``harness/spans.py``)."""

from harness.spans import idle_share


def read(ctx):
    return idle_share(ctx, "starframe.tables")
