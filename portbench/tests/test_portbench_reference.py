"""The plain reference against the port's own plain paths, in f32 on
the CPU at a small size: both are driven through a whole run of each
cell kind, and every number the check compares reads (next to) zero."""

import time

import pytest
import torch

from portbench import run

from tiny import loose, removal, train


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(cfg, mix, limits, seed=7, trace=False, metrics=()):
    return run.run_cell("tiny", {"limits": loose(limits)}, cfg, mix,
                        list(metrics), seed, 0.5, trace, "cpu",
                        time.perf_counter())


REMOVAL_LIMITS = ("s1_outliers", "s2_outliers", "frame_err",
                  "prop_px_share", "frame_outside_max")
TRAIN_LIMITS = ("loss_err", "update_err", "gen_out_err")


@pytest.mark.parametrize("hole", ["square", "strokes"])
def test_removal_reference_equals_port_f32(hole):
    cfg, mix = removal("f32", hole)
    res = _run(cfg, mix, REMOVAL_LIMITS, metrics=["frames_per_s",
                                                  "setup_s"])
    checks = {k: v["value"] for k, v in res["checks"].items()}
    print(checks)
    assert res["correct"] and res["attempted"] >= 1
    assert checks["s1_outliers"] == 0 and checks["s2_outliers"] == 0
    assert checks["frame_err"] <= 0.05 and checks["frame_outside_max"] == 0
    assert checks["prop_px_share"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_train_reference_equals_port_f32():
    cfg, mix = train("f32")
    res = _run(cfg, mix, TRAIN_LIMITS)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    print(checks)
    assert all(v <= 1e-5 for v in checks.values())


def test_traced_run_reads_its_metrics():
    cfg, mix = train("bf16")
    res = _run(cfg, mix, TRAIN_LIMITS, trace=True,
               metrics=["mfu.train", "peak_device_gib.train"])
    assert res["metrics"]["mfu.train"]["value"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["ctx"]["flops_per_item"] > 0


def test_traced_removal_run_reads_its_metrics():
    cfg, mix = removal("bf16")
    res = _run(cfg, mix, REMOVAL_LIMITS, trace=True,
               metrics=["mfu.infer", "stage_ms.s3_s5_host"])
    assert res["metrics"]["mfu.infer"]["value"] > 0
    assert res["metrics"]["stage_ms.s3_s5_host"]["value"] > 0
    assert res["ctx"]["window_flops"] > 0
    assert set(res["ctx"]["bound_s"]) == {"k1", "k2"}
