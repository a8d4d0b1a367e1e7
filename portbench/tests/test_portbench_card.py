"""On the card only (marker ``cuda``; skips elsewhere): one short run of
each cell through the command, correct, with every metric the cell
reports."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["removal_square_24f_432x240",
                                  "fgt_train_b2_240x432",
                                  "removal_strokes_24f_432x240"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2 ** 33 + 5), "--seconds", "3", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["metrics"]
