"""The program's ``starframe.*`` spans in a traced window: where the
device's idle time fell, by what the program was doing.

The program records its spans with ``torch.profiler.record_function``
while a profiler records (``starframe_tpu_torch/spans.py``), so they sit
in the same Chrome trace as the device events, on the same clock. Spans
nest on the calling thread, each call's inside its ``starframe.rollout``.
A span's *self intervals* are its interval less the parts its nested
``starframe.*`` spans cover: the self intervals of all spans, and the
time under none (the harness's reset, synchronize and read), partition
the window. The device's idle time inside each piece is the length of its
intersection with the gaps between device intervals, exactly (no
midpoint rule), so the idle times of the pieces sum to the window's."""

from __future__ import annotations

from . import trace

PREFIX = "starframe."
ROOT = PREFIX + "rollout"


def program_spans(host, t0_us: float, t1_us: float) -> list:
    """The ``starframe.*`` host events ``(name, start, end)`` that start
    inside ``[t0, t1]``, clipped to it."""
    return [(n, s, min(e, t1_us)) for n, s, e in host
            if n.startswith(PREFIX) and t0_us <= s < t1_us]


def self_intervals(spans, t0_us: float, t1_us: float) -> list:
    """``[(start, end, name)]`` partitioning ``[t0, t1]``: each piece goes
    to the innermost span over it (the latest started; of two started at
    once, the shorter), ``None`` where no span is."""
    marks = []
    for i, (_, s, e) in enumerate(spans):
        if e > s:
            marks += [(s, 1, i), (e, 0, i)]
    marks.sort()  # at one time, ends before starts
    out, active, cur = [], {}, t0_us
    for t, start, i in marks:
        if t > cur:
            out.append((cur, t, max(active.values())[2] if active else None))
            cur = t
        if start:
            s, e = spans[i][1:]
            active[i] = (s, -e, spans[i][0])
        else:
            active.pop(i)
    if t1_us > cur:
        out.append((cur, t1_us, None))
    return out


def idle_gaps(dev, t0_us: float, t1_us: float) -> list:
    """The gaps ``(start, end)`` between the device intervals of ``dev``
    inside ``[t0, t1]``, in order."""
    gaps, cur = [], t0_us
    for s, e in trace.union((d[2], d[3]) for d in dev):
        if s > cur:
            gaps.append((cur, min(s, t1_us)))
        cur = max(cur, e)
    if t1_us > cur:
        gaps.append((cur, t1_us))
    return [(s, e) for s, e in gaps if e > s]


def idle_by_span(pieces, gaps) -> dict:
    """``{name (None: no span): idle seconds}``: the length of each
    piece's intersection with the gaps (both sorted and disjoint)."""
    out, k = {}, 0
    for s, e, name in pieces:
        while k < len(gaps) and gaps[k][1] <= s:
            k += 1
        j, idle = k, 0.0
        while j < len(gaps) and gaps[j][0] < e:
            idle += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
        out[name] = out.get(name, 0.0) + idle * 1e-6
    return out


def reduce(traced: dict) -> dict | None:
    """The spans of a reduced trace (``run.reduce_trace``'s ``dev``,
    ``host``, ``t0_us``, ``t1_us``): ``counts`` ``{name: spans}``,
    ``self_s`` and ``idle_s`` ``{name or None: seconds}``; None where the
    window holds no ``starframe.rollout`` (a program without spans)."""
    t0, t1 = traced["t0_us"], traced["t1_us"]
    spans = program_spans(traced["host"], t0, t1)
    counts = {}
    for name, _, _ in spans:
        counts[name] = counts.get(name, 0) + 1
    if ROOT not in counts:
        return None
    pieces = self_intervals(spans, t0, t1)
    self_s = {}
    for s, e, name in pieces:
        self_s[name] = self_s.get(name, 0.0) + (e - s) * 1e-6
    return dict(counts=counts, self_s=self_s,
                idle_s=idle_by_span(pieces, idle_gaps(traced["dev"], t0, t1)))


def idle_share(ctx, name: str):
    """The device's idle time inside ``name``'s self intervals, as a share
    (%) of the traced window; None without spans or device events."""
    t = ctx.trace
    r = None if t is None or t["busy_s"] <= 0 else reduce(t)
    if r is None:
        return None
    return 100.0 * r["idle_s"].get(name, 0.0) / t["window_s"]


def per_frame(ctx, name: str):
    """``name``'s spans a traced frame; None without spans."""
    t = ctx.trace
    r = None if t is None or not t["frames"] else reduce(t)
    if r is None:
        return None
    return r["counts"].get(name, 0) / t["frames"]
