"""The harness finds every configuration, traffic mix, cell and metric
of BENCHMARK.json by its name."""

import json
import os

import pytest

from portbench import common, run, traffic

ROOT = os.path.dirname(common.HERE)


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_configs_and_cells_resolve(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        cell, cfg, mix = run.load_cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        assert configs[w["config"]]["file"].endswith(f"{w['config']}.json")
        assert os.path.isfile(os.path.join(common.HERE, "kinds",
                                           f"{cfg['kind']}.py"))
        assert mix == traffic.load_mix(w["traffic"])
        assert callable(common.load_module("generators", mix["kind"]).make)
        assert set(cell["limits"])
        ranges = cfg["op_ranges"]
        for label, (mod, attr) in common.op_targets(ranges).items():
            assert callable(getattr(mod, attr))
            assert callable(common.load_module(
                "rules", ranges[label]["rule"]).bound_s)


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_cell_metrics(bench):
    got = run.cell_metrics(bench, "fgt_train_b2_240x432", False)
    assert got == ["train_steps_per_s", "setup_s"]
    got = run.cell_metrics(bench, "removal_square_24f_432x240", True)
    assert "k1_roofline" in got and "k45_roofline" not in got
    for w in bench["workloads"]:
        e2e = run.cell_metrics(bench, w["name"], False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(bench, w["name"], True)


def test_command_and_paths(bench):
    assert bench["command"] == ["python3", "-m", "portbench.run"]
    assert bench["paths"] == ["portbench"]
