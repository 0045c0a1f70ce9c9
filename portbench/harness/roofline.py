"""Roofline shares and the step's share of the peak from the traced
episodes: the least time of the counted work (``roofline/<kernel>.py``,
from the problem's counts over the same episodes) over the device time the
trace gives the kernel, or over the traced wall."""

from __future__ import annotations

from . import cells, peaks, trace


def least_s(ctx, kernel: str) -> float:
    """Least time of ``kernel``'s work over the traced episodes."""
    mod = cells.roofline_count(kernel)
    flops, nbytes = mod.work(ctx)
    return peaks.least_time_s(flops, nbytes)


def share(ctx, kernel: str):
    """``kernel``'s roofline share in %, or None where the trace holds no
    launch of it."""
    if ctx.trace is None or ctx.counts is None:
        return None
    mod = cells.roofline_count(kernel)
    dev_s = trace.kernel_seconds(ctx.trace["dev"], mod.PATTERN)
    if dev_s <= 0.0:
        return None
    return 100.0 * least_s(ctx, kernel) / dev_s


def counted_kernels() -> list:
    """Every kernel with a work count under ``roofline/``."""
    return sorted(p.stem for p in (cells.BENCH / "roofline").glob("*.py"))


def step_share(ctx, kernels):
    """The counted work of those of ``kernels`` that ran, as a share (%)
    of the peak over the traced wall; None without a trace or a launch of
    them."""
    if ctx.trace is None or ctx.counts is None:
        return None
    dev = ctx.trace["dev"]
    present = [k for k in kernels if trace.kernel_seconds(
        dev, cells.roofline_count(k).PATTERN) > 0.0]
    if not present:
        return None
    return (100.0 * sum(least_s(ctx, k) for k in present)
            / ctx.trace["window_s"])


def episodes(ctx) -> float:
    """Traced episodes per counted episode (the counts cover one)."""
    return float(ctx.trace["episodes"])
