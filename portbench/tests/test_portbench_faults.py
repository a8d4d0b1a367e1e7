"""A run driven on the CPU at a small size (the harness's look for a
card skipped) with the timed path broken underneath must come out not
correct under the cell's limits, once for each fault the cell can have;
and the control (the reference in fp8 in the program's place) must read
well above the program on some compared number."""

import time

import pytest
import torch

from portbench import control, run

from tiny import load, removal, train


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(cell_name, cfg, mix, seed=11):
    cell = load("workloads", f"{cell_name}.json")
    return run.run_cell(cell_name, cell, cfg, mix, [], seed, 0.3, False,
                        "cpu", time.perf_counter())


def _values(res):
    return {k: v["value"] for k, v in res["checks"].items()}


def _altered(vi, monkeypatch):
    fn = vi.fgt_synthesis
    monkeypatch.setattr(vi, "fgt_synthesis", lambda *a, **k: (
        fn(*a, **k).int() + 40).clamp(0, 255).to(torch.uint8))


def _unchanged(vi, monkeypatch):
    monkeypatch.setattr(vi, "complete_flows",
                        lambda models, flows, *a, **k: flows.float())


def _half_pairs(vi, monkeypatch):
    fn = vi.refine_pairs

    def half(models, feats, src, dst, *a, **k):
        n = src.shape[0] // 2
        got = fn(models, feats, src[:n], dst[:n], *a, **k)
        return torch.cat([got, -got])
    monkeypatch.setattr(vi, "refine_pairs", half)


def _no_propagation(vi, monkeypatch):
    # registered so that the test's end puts the original back
    monkeypatch.setattr(vi, "get_flownn_gradient_frames",
                        vi.get_flownn_gradient_frames)
    control.no_propagation(vi)


@pytest.mark.parametrize("cell", ["removal_square_24f_432x240",
                                  "removal_strokes_24f_432x240"])
@pytest.mark.parametrize("fault", [_altered, _unchanged, _half_pairs,
                                   _no_propagation])
def test_removal_fault_is_not_correct(cell, fault, monkeypatch):
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    cfg, mix = removal("bf16", "square" if "square" in cell else "strokes")
    sound = _values(_run(cell, cfg, mix))
    fault(vi, monkeypatch)
    res = _run(cell, cfg, mix)
    print(fault.__name__, sound, _values(res))
    assert res["correct"] is False


def _no_update(monkeypatch):
    from fgt_tpu_torch.train.fgt_step import FGTTrainStep

    fn = FGTTrainStep.__call__

    def call(self, batch):
        saved = [(o, o.step) for o in (self.g_opt, self.d_opt)]
        for o, _ in saved:
            o.step = lambda *a, **k: None
        try:
            return fn(self, batch)
        finally:
            for o, s in saved:
                o.step = s
    monkeypatch.setattr(FGTTrainStep, "__call__", call)


def _half_batch(monkeypatch):
    from fgt_tpu_torch.train.fgt_step import FGTTrainStep

    fn = FGTTrainStep.__call__
    monkeypatch.setattr(FGTTrainStep, "__call__", lambda self, batch: fn(
        self, {k: v[:v.shape[0] // 2] for k, v in batch.items()}))


def _frozen_small(monkeypatch):
    from fgt_tpu_torch.train.fgt_step import FGTTrainStep

    fn = FGTTrainStep.__call__
    monkeypatch.setattr(FGTTrainStep, "__call__", lambda self, batch: (
        control.frozen_small_call(self, lambda b: fn(self, b), batch)))


@pytest.mark.parametrize("fault", [_no_update, _half_batch, _frozen_small])
def test_train_fault_is_not_correct(fault, monkeypatch):
    cfg, mix = train("bf16")
    cell = "fgt_train_b2_240x432"
    sound = _values(_run(cell, cfg, mix))
    fault(monkeypatch)
    res = _run(cell, cfg, mix)
    print(fault.__name__, sound, _values(res))
    assert res["correct"] is False


def test_removal_control_reads_above_the_program():
    cfg, mix = removal("bf16")
    prog = control.removal_reading(cfg, mix, 5, "program", "cpu")
    ctrl = control.removal_reading(cfg, mix, 5, "control", "cpu")
    print(prog, ctrl)
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in
               ("s1_outliers", "s2_outliers", "frame_err")) >= 3


def test_train_control_reads_above_the_program():
    cfg, mix = train("bf16")
    prog = control.train_reading(cfg, mix, 5, "program", "cpu")
    ctrl = control.train_reading(cfg, mix, 5, "control", "cpu")
    half = control.train_reading(cfg, mix, 5, "half_batch", "cpu")
    print(prog, ctrl, half)
    keys = ("loss_err", "update_err", "gen_out_err")
    assert max(ctrl[k] / max(prog[k], 1e-12) for k in keys) >= 3
    assert max(half[k] / max(prog[k], 1e-12) for k in keys) >= 10
