"""On the card only (marker ``cuda``; skips elsewhere): a short run of
the video-extrapolation cell through the command is correct and reports
every metric ``BENCHMARK.json`` lists for it."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "outpaint_2x_24f"


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_outpaint_cell_runs_correct(card, trace):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELL,
         "--seed", str(2 ** 33 + 11), "--seconds", "3", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(run.cell_metrics(bench, CELL,
                                                       bool(trace)))
    assert list(res)[-1] == "checks"
