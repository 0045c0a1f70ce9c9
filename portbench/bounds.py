#!/usr/bin/env python3
"""Spreads of a cell's end-to-end metrics over two sets of runs, and the
bound they suggest:

    python3 portbench/bounds.py <run output> ... --sets A B

Each argument is a file whose last line is one run's result; a file's set
is the first of ``--sets`` its name starts with (``A1.out`` ... ``B6.out``).
A spread is the distance between the first and third quartile over the
median (``statistics.quantiles``); the suggestion is five times the wider
of the two sets' spreads, at least 1% and at most 25%."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness.stats import spread  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--sets", nargs="+", default=["A", "B"])
    args = ap.parse_args()
    values = {}  # metric -> set -> [values]
    for f in args.files:
        name = Path(f).name
        tag = next((s for s in args.sets if name.startswith(s)), None)
        if tag is None:
            continue
        res = json.loads(Path(f).read_text().strip().splitlines()[-1])
        for m, v in res["metrics"].items():
            values.setdefault(m, {}).setdefault(tag, []).append(v["value"])
    out = {}
    for m, sets in values.items():
        spreads = {t: spread(v) for t, v in sets.items() if len(v) >= 2}
        widest = max(spreads.values())
        medians = {t: statistics.median(v) for t, v in sets.items()}
        out[m] = dict(medians=medians, spreads=spreads,
                      bound=min(0.25, max(0.01, 5 * widest)))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
