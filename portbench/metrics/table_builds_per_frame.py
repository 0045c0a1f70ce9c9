"""Table builds a traced frame: the program's ``starframe.tables`` spans
(scheduled and forced builds, and a call's first) over the traced frames
(``harness/spans.py``)."""

from harness.spans import per_frame


def read(ctx):
    return per_frame(ctx, "starframe.tables")
