#!/usr/bin/env python3
"""The loops of the built kernels, counted in SASS instructions.

    python3 tools/sass_loops.py [ROOT ...] [--kernel elig_kernel]

For each package root (default: this checkout) builds the kernels' library
as the package does at first use (``hopper/_build.py``), disassembles it
with ``cuobjdump -sass`` and prints, for every kernel whose demangled name
holds ``--kernel``, its instruction count and each loop's: the
instructions from a label to the last branch back to it, nested loops
counted in the loop that holds them too. A loop's count over the bytes or
items one pass handles is the kernel's instructions per byte or item.
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``); no card.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
BRANCH = re.compile(r"\bBRA\b.*?(?:\((\.L_x_\d+)\)|\b(0x[0-9a-f]+)\b)")


def library_path(root: str) -> str:
    """Build (or find) ``root``'s kernel library in a child process."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from starframe_tpu_torch.hopper import _build; "
            "_build.library(); print(_build._library_path())")
    out = subprocess.run([sys.executable, "-c", code, root], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[-1]


def functions(so: str) -> dict:
    """``{mangled name: SASS lines}`` of every kernel in ``so``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def loops(lines) -> tuple:
    """``(instructions, [(label, instructions in the loop), ...])``."""
    n, at, spans = 0, {}, {}  # at: label or address -> instructions before
    for line in lines:
        m = LABEL.match(line)
        if m:
            at[m.group(1)] = n
            continue
        m = INSN.search(line)
        if not m:
            continue
        at[hex(int(m.group(1), 16))] = n
        n += 1
        b = BRANCH.search(m.group(2))
        target = b and (b.group(1) or hex(int(b.group(2), 16)))
        if target in at:  # a branch back: a loop's end
            spans[target] = n - at[target]
    return n, sorted(spans.items(), key=lambda kv: at[kv[0]])


def demangle(names) -> list:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout
    return out.splitlines()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", default=[HERE])
    ap.add_argument("--kernel", default="elig_kernel")
    args = ap.parse_args()
    for root in args.roots:
        root = os.path.abspath(root)
        funcs = functions(library_path(root))
        for mangled, pretty in zip(funcs, demangle(funcs)):
            if args.kernel not in pretty:
                continue
            n, spans = loops(funcs[mangled])
            print(f"{root}: {pretty}: {n} instructions; loops "
                  + (", ".join(f"{lab} {k}" for lab, k in spans) or "none"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
