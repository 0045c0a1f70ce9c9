"""The comparison that decides ``correct``: each sampled call's answer (the
final state the program returned) against the plain reference (the cell's
reference package, ``Cell.reference``) run over the same frames from the
same input state, with the actions the call ran with.

Numbers over the dynamic bodies of the sampled calls: the position gap's
median, 99th percentile and maximum (m), the angle gap's 99th percentile
(rad); ``frames_gap``, how far a world's step counter moved from the
call's frames; ``counter_misses``, the sampled calls' hard counters
that read 0 where the reference found, at the call's first frame, more
partners than the slots hold (``entries/<entry>.py``'s ``implied``: a
counter may flag more than the reference sees, never less); and
``flagged_unchecked``, the flagged calls' positions (a hard counter above
0) left out of the samples (the window keeps each, so the answers of
flagged calls are held to the reference like the rest). Each is held
to the limit in ``limits/<cell>.json``; ``PERF.md`` gives the readings
each limit was set from."""

from __future__ import annotations

import math

import torch

from . import cells


def _package(reference):
    """``reference``, or the default reference package where it is None."""
    return cells.reference_package() if reference is None else reference


def reference_config(solver: dict, entry_name: str, reference=None) -> dict:
    """The reference's frame settings from the configuration file's
    solver block (the reference package's ``config``)."""
    return _package(reference).config(solver, entry_name)


def world_state(world, reference=None) -> dict:
    """A program world's dynamic state as flat ``[B]`` tensors (copies),
    with :func:`joint_state`'s (the reference package's
    ``world_state``)."""
    return _package(reference).world_state(world)


def joint_state(world, reference=None) -> dict:
    """The per-call inputs a control wrote into ``world`` (the reference
    package's ``actions``). Taken from the world the call is handed, they
    are the inputs it ran with, and the reference runs with them in place
    of the scene's."""
    return _package(reference).actions(world)


def gaps(out: dict, ref: dict, dynamic) -> dict:
    """Per-body gaps of ``out`` against ``ref`` over the dynamic bodies:
    ``pos`` (m), ``ang`` (rad)."""
    f = torch.float32
    dx = out["px"].to(f) - ref["px"].to(f)
    dy = out["py"].to(f) - ref["py"].to(f)
    return dict(pos=torch.sqrt(dx * dx + dy * dy)[dynamic],
                ang=torch.abs(out["an"].to(f) - ref["an"].to(f))[dynamic])


def quantile(x, q: float) -> float:
    """The ``q`` quantile (0-1) of a tensor of any size."""
    x = x.double()
    if x.numel() > (1 << 24):  # torch.quantile's input limit
        k = max(1, int(round((1.0 - q) * x.numel())))
        return float(torch.topk(x, k).values[-1])
    return float(torch.quantile(x, q))


def numbers(pos, ang) -> dict:
    """The compared numbers of the concatenated per-body gaps."""
    return dict(pos_gap_median_m=quantile(pos, 0.5),
                pos_gap_p99_m=quantile(pos, 0.99),
                pos_gap_max_m=float(pos.max()),
                ang_gap_p99_rad=quantile(ang, 0.99))


def reference_outputs(geom, rcfg, samples, frames: int, dtype=torch.float32,
                      reference=None):
    """The reference's answer to each sample's input state, and its counts
    at the call's first frame (the package's ``frame.frame`` ``stats``)."""
    ref = _package(reference)
    g = ref.world.cast_geom(geom, dtype)
    outs, counts = [], []
    for s in samples:
        first = {}
        st = ref.frame.frame(g, ref.world.cast(s["in"], dtype), rcfg, first)
        outs.append(ref.frame.rollout(g, st, rcfg, frames - 1))
        counts.append(first)
    return outs, counts


def counter_misses(samples, counts, implied, solver: dict) -> int:
    """Hard counters of the sampled calls that read 0 where the reference
    says they had to flag."""
    return sum(s["hard"].get(k, 0) == 0
               for s, c in zip(samples, counts) for k in implied(c, solver))


def flagged_unchecked(flagged, samples) -> int:
    """The episode positions whose call flagged in the window (a hard
    counter above 0) with no checked call among the samples."""
    return len(set(flagged) - {s["pos"] for s in samples})


def frames_gap(samples, frames: int) -> int:
    """The largest gap, over the sampled calls and their worlds, between
    the frames the world's step counter advanced and the call's frames."""
    return max(int((s["out"]["steps"] - s["in"]["steps"] - frames).abs().max())
               for s in samples)


def compare(samples, refs, answers, dynamic) -> dict:
    """The compared numbers of ``answers`` (one state per sample) against
    ``refs``."""
    pos, ang = [], []
    for ref, ans in zip(refs, answers):
        g = gaps(ans, ref, dynamic)
        pos.append(g["pos"])
        ang.append(g["ang"])
    out = numbers(torch.cat(pos), torch.cat(ang))
    out["samples"] = len(samples)
    return out


def verdict(values: dict, limits: dict) -> tuple:
    """``(correct, rows)``: each limited number with its limit, and
    whether every one is within it (a missing or NaN number fails)."""
    rows, ok = {}, True
    for name, spec in limits["numbers"].items():
        v = values.get(name)
        known = v is not None and v == v  # a missing or NaN number fails
        ok &= bool(known and spec.get("min", -math.inf) <= v
                   <= spec.get("max", math.inf))
        rows[name] = dict(value=v, limit=spec)
    return ok, rows
