"""Build-time host helpers: greedy colouring of the joint graph.

The counterpart of ``greedy_color`` in ``starframe_tpu/native/`` (a C++
helper loaded with ctypes, ``coloring.cpp``, with a Python fallback). It
runs once per scene build on at most a few hundred joints, so the port
keeps it in plain Python and numpy; it gives the same colours as the C++
routine.
"""

from __future__ import annotations

import numpy as np


def greedy_color(body_a, body_b, active=None, body_is_static=None,
                 n_bodies=None):
    """Colour a constraint graph so that no two constraints of one colour
    share a non-static body. Returns ``(colors [n] int32, n_colors)``.

    Constraint ``i`` (in index order) takes the smallest colour that no
    earlier active constraint on one of its non-static bodies holds.
    Inactive constraints get colour 0 and block nothing. A static body
    (never moved by an impulse) may carry any number of constraints of one
    colour, and out-of-range body indices are treated like static ones."""
    body_a = np.asarray(body_a, np.int32)
    body_b = np.asarray(body_b, np.int32)
    n = len(body_a)
    if n_bodies is None:
        n_bodies = int(max(body_a.max(initial=-1), body_b.max(initial=-1))) + 1
    active = (np.ones(n, bool) if active is None
              else np.asarray(active).astype(bool))
    static = (np.zeros(n_bodies, bool) if body_is_static is None
              else np.asarray(body_is_static).astype(bool))

    def tracked(b):
        return 0 <= b < n_bodies and not static[b]

    colors = np.zeros(n, np.int32)
    by_body: dict[int, list[int]] = {}
    n_colors = 0
    for i in range(n):
        if not active[i]:
            continue
        ends = [int(b) for b in (body_a[i], body_b[i]) if tracked(int(b))]
        used = {int(colors[j]) for b in ends for j in by_body.get(b, ())}
        c = 0
        while c in used:
            c += 1
        colors[i] = c
        n_colors = max(n_colors, c + 1)
        for b in ends:
            by_body.setdefault(b, []).append(i)
    return colors, max(n_colors, 1)
