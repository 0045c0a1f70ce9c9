"""The device's idle time inside the program's per-call set-up
(``starframe.setup``'s self intervals: a batch's eligibility mask, owner
lists and joint slots; the tile layout's entry and first edges), as a
share (%) of the traced episodes' wall (``harness/spans.py``)."""

from harness.spans import idle_share


def read(ctx):
    return idle_share(ctx, "starframe.setup")
