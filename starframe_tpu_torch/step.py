"""Sleep coupling across joints, batch-first.

The PyTorch counterpart of ``starframe_tpu/step.py``'s ``_joint_slow_closure``
and ``_joint_wake_closure``: the island rule every tier shares. Bodies are
``[W, N]`` and joint endpoints ``[W, J]``; the scatters run on int32, so
their min and max give one answer whatever the order. The rest of the
single-world step is ROADMAP.md A3.
"""

from __future__ import annotations

import torch


def _scatter(vals, ja, jb, pair, reduce: str):
    """``vals [W, N]`` i32 reduced (``"amin"``/``"amax"``) with ``pair [W,
    J]`` at both endpoints of every joint."""
    out = vals.scatter_reduce(1, ja, pair, reduce=reduce, include_self=True)
    return out.scatter_reduce(1, jb, pair, reduce=reduce, include_self=True)


def joint_slow_closure(slow, body_a, body_b, active, hops: int = 3):
    """A body counts as slow only while its joint partners are slow too,
    so a jointed pair sleeps as a pair (``step.py:146-163``). ``slow [W,
    N]`` bool, joint endpoints ``[W, J]`` i32, ``active [W, J]`` bool;
    ``hops`` bounds the propagation along chains within a frame."""
    if body_a.shape[-1] == 0:
        return slow
    ja, jb = body_a.long(), body_b.long()
    inert = ~active
    for _ in range(hops):
        ps = ((torch.gather(slow, 1, ja) & torch.gather(slow, 1, jb))
              | inert).to(torch.int32)
        slow = _scatter(slow.to(torch.int32), ja, jb, ps, "amin") > 0
    return slow


def joint_wake_closure(wake, body_a, body_b, active, hops: int = 3):
    """Waking one endpoint of an active joint wakes the other
    (``step.py:166-177``); arguments as :func:`joint_slow_closure`."""
    if body_a.shape[-1] == 0:
        return wake
    ja, jb = body_a.long(), body_b.long()
    for _ in range(hops):
        pw = ((torch.gather(wake, 1, ja) | torch.gather(wake, 1, jb))
              & active).to(torch.int32)
        wake = _scatter(wake.to(torch.int32), ja, jb, pw, "amax") > 0
    return wake
