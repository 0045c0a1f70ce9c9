"""Reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics read: device intervals and their union, kernel time by name, the
idle gaps and what the host was doing in each.

Device work is every complete event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; busy time is the length of the union of
their intervals inside the traced window, and the idle share is the rest of
the window."""

from __future__ import annotations

import functools
import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
CSRC = Path(__file__).resolve().parents[2] / "starframe_tpu_torch" / "csrc"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


@functools.cache
def hand_kernels(csrc: Path = CSRC) -> tuple:
    """The program's hand-written kernels: every ``__global__`` function of
    its CUDA sources, longest name first."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return tuple(sorted(names, key=lambda n: (-len(n), n)))


def load_events(path) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_events(events, t0_us: float | None = None,
                  t1_us: float | None = None) -> list:
    """Device events ``(name, cat, start_us, end_us)`` inside ``[t0, t1]``
    (clipped), in start order."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        en = s + d
        if t0_us is not None:
            s = max(s, t0_us)
        if t1_us is not None:
            en = min(en, t1_us)
        if en > s:
            out.append((e["name"], e["cat"], s, en))
    out.sort(key=lambda x: x[2])
    return out


def host_events(events) -> list:
    """Host events ``(name, start_us, end_us)``."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and "dur" in e]


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_us(dev) -> float:
    return sum(e - s for s, e in union((d[2], d[3]) for d in dev))


def kernel_label(name: str, cat: str, hand=None) -> str:
    """A device op's row in the breakdown: a hand-written kernel (of
    ``hand``, by default :func:`hand_kernels`) by its name, copies and
    sets by kind, every other kernel (PyTorch's own elementwise,
    reduction, sort and index kernels) as one row."""
    if cat == "gpu_memcpy":
        return "memcpy"
    if cat == "gpu_memset":
        return "memset"
    for k in hand_kernels() if hand is None else hand:
        if re.search(r"(?<![A-Za-z0-9_])" + k + r"\b", name):
            return k
    return "small PyTorch ops"


def device_by_label(dev, hand=None) -> dict:
    """``{label: seconds}`` of device time."""
    out = {}
    for name, cat, s, e in dev:
        lab = kernel_label(name, cat, hand)
        out[lab] = out.get(lab, 0.0) + (e - s) * 1e-6
    return out


def kernel_seconds(dev, pattern: str) -> float:
    """Device seconds of the kernels whose name matches ``pattern`` (a
    regular expression)."""
    rx = re.compile(pattern)
    return sum(e - s for name, cat, s, e in dev
               if cat == "kernel" and rx.search(name)) * 1e-6


def idle_gaps(dev, host, t0_us: float, t1_us: float) -> dict:
    """``{what the host was doing: seconds}`` over the device's idle gaps
    inside ``[t0, t1]``: each gap goes to the innermost (shortest) host
    event running at its midpoint (``idle`` where none is)."""
    gaps, cur = [], t0_us
    for s, e in union((d[2], d[3]) for d in dev):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1_us > cur:
        gaps.append((cur, t1_us))
    host = sorted(host, key=lambda h: h[1])
    out, active, k = {}, [], 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (s + e)
        while k < len(host) and host[k][1] <= mid:
            active.append(host[k])
            k += 1
        active = [h for h in active if h[2] > mid]
        best = min(active, key=lambda h: h[2] - h[1], default=None)
        lab = best[0] if best else "idle"
        out[lab] = out.get(lab, 0.0) + (e - s) * 1e-6
    return out


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest ``[name, value]`` of ``d``."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
