"""The per-layer metrics read from the program's spans and counters
(``portbench/spans.py``): a traced run of each kind, driven on the CPU
at a small size, reports every metric its cell lists, the new ones read
from host durations, the kernel rooflines aside (no device time on the
CPU: the card test below reads them). The op ranges still catch their
calls under the spans."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import common, run

from tiny import load, loose, removal, train

ROOT = os.path.dirname(common.HERE)
# read device time at a kernel's call boundary: none on the CPU
ROOFLINES = {"k1_roofline", "k2_roofline.infer", "k2_roofline.train",
             "k45_roofline"}
SPAN_METRICS = ("span_ms.", "step_ms.", "pcg_iters.", "poisson_px.")


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _traced(cell_name, cfg, mix, metrics, seed=2 ** 33 + 3):
    from fgt_tpu_torch.utils import profiling

    cell = load("workloads", f"{cell_name}.json")
    profiling.reset_spans()
    res = run.run_cell(cell_name, {"limits": loose(cell["limits"])}, cfg,
                       mix, metrics, seed, 0.3, True, "cpu",
                       time.perf_counter())
    return res, profiling.spans()


@pytest.mark.parametrize("cell", ["removal_square_24f_432x240",
                                  "removal_strokes_24f_432x240",
                                  "fgt_train_b2_240x432"])
def test_traced_run_reports_every_metric_of_its_cell(cell, bench):
    metrics = run.cell_metrics(bench, cell, True)
    mine = [m for m in metrics if m.startswith(SPAN_METRICS)]
    if cell.startswith("removal"):
        cfg, mix = removal("bf16", cell.split("_")[1])
        assert len(mine) == 11
    else:
        cfg, mix = train("bf16")
        assert len(mine) == 6
    res, recs = _traced(cell, cfg, mix, metrics)
    got = res["metrics"]
    assert set(got) == set(metrics) - ROOFLINES
    for m in mine:
        assert got[m]["value"] > 0, m
    # the op ranges caught their calls (their bounds are counted)
    assert res["ctx"]["bound_s"] and all(
        v > 0 for v in res["ctx"]["bound_s"].values())
    # one root a clip or step; children inside their parents
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    n = cfg["profile_clips"] if cell.startswith("removal") else \
        cfg["profile_steps"]
    assert len(roots) == n
    for r in recs:
        if r["parent"] is not None:
            up = by_id[r["parent"]]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
                up["end_ns"]


def test_readers_give_nothing_without_a_root():
    from fgt_tpu_torch.utils import profiling

    profiling.reset_spans()
    for name in ("span_ms.s1_encode", "pcg_iters.s2", "step_ms.cast"):
        read = common.metric_reader(name)
        for kind in ("infer", "train"):
            assert read({"kind": kind, "trace": {}}) is None
            assert read({"kind": kind}) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["removal_square_24f_432x240",
                                  "fgt_train_b2_240x432"])
def test_traced_cell_reports_every_metric_on_the_card(card, cell, bench):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2 ** 33 + 9), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(run.cell_metrics(bench, cell, True))
