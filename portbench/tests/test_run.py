"""``run.py`` measures the card only: without one it exits non-zero and
prints no result; nor does it print one where the run loaded JAX or the
JAX package."""

import json
import os
import subprocess
import sys
import types

import pytest

from harness import cells
import run


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


RESULT = dict(correct=True, attempted=1, failed=0, metrics={}, device={},
              setup=dict(built=False, build_s=0.0, without_build_s=1.0))


@pytest.mark.parametrize("loaded,refused", [
    ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("starframe_tpu.pallas", True), ("starframe_tpu_torch.hopper", False)])
def test_a_run_that_loaded_jax_prints_no_result(loaded, refused,
                                                monkeypatch, capsys):
    """Past the look for a card and the run itself (both stood in for),
    ``main`` looks in ``sys.modules`` by whole top-level names."""
    torch = pytest.importorskip("torch")
    for name in list(sys.modules):
        if name.split(".", 1)[0] in run.JAX:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: (RESULT, {}))
    rc = run.main(["--workload", "batched_rl.step4", "--seed", "1",
                   "--seconds", "1"])
    out, err = capsys.readouterr()
    if refused:
        assert rc != 0 and out == ""
        assert loaded.split(".")[0] in err
    else:
        assert rc == 0
        assert json.loads(out.strip().splitlines()[-1])["correct"]
