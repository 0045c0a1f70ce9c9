"""``run.py`` measures the card only: without one it exits non-zero and
prints no result."""

import os
import subprocess
import sys

import pytest

from harness import cells


@pytest.mark.parametrize("cell", ["batched_rl.step4", "batched_rl.step1"])
def test_refuses_without_a_card(cell):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=cells.ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
