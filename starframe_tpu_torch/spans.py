"""Named spans of the rollouts' layers on ``torch.profiler``'s clock.

Tracing is on exactly when a ``torch.profiler`` records: :func:`span` then
returns ``torch.profiler.record_function(name)``, which the profiler keeps
beside the device events and writes into the same Chrome trace, so each
span shares the device trace's clock. Otherwise it returns one shared
no-op context, at the cost of one check of the profiler's state. The
names, all ``starframe.*``:

- ``starframe.rollout``: a whole ``batched_rollout`` or ``tiled_rollout``
  call, the root of every span below it on the calling thread;
- ``starframe.setup``: the call's set-up (``parallel.frame2_inputs`` and
  the eligibility mask; on the tile engine two spans, the layout's entry
  and its first edges);
- ``starframe.tables``: a table build (K2, its host prep and the
  budget's scatter; K5 and its counters);
- ``starframe.guard``: the staleness guard's verdicts and their blocking
  host read;
- ``starframe.joints``: a jointed batch's joint work outside the frame
  kernel: the joint slots (K3), the kernel's joint arrays and the
  ``joint_overflow`` count, built once a call inside ``starframe.setup``
  (inside ``starframe.frame`` when a lone ``frame2_step`` builds its own);
  a batch without joints opens none;
- ``starframe.frame``: one frame (``parallel.frame2_step``; the tile
  engine's ``_run_frame`` and its solve counts);
- ``starframe.sort``: the tile layout's re-sort and the edges after it;
- ``starframe.exit``: the tile layout's sort back to canonical order.
"""

from __future__ import annotations

import contextlib

import torch

NULL = contextlib.nullcontext()
# whether a profiler records: the spans are on, and so are the counters
# the program keeps only under a trace
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """``record_function(name)`` while a profiler records, else
    :data:`NULL`."""
    if not recording():
        return NULL
    return torch.profiler.record_function(name)
