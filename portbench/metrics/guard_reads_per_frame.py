"""The staleness guard's blocking host reads a traced frame: the
program's ``starframe.guard`` spans over the traced frames
(``harness/spans.py``)."""

from harness.spans import per_frame


def read(ctx):
    return per_frame(ctx, "starframe.guard")
