"""The benchmark's video-extrapolation cell (``portbench``'s
``outpaint_2x_24f``) on the CPU at a small size: 6 frames of 32x32
extrapolated 2x onto a 64x64 canvas, LAFC and FGT at small widths.

The reference's canvas step equals the port's exactly; a whole run of
the cell through ``portbench.run.run_cell`` in f32 reads (next to) zero
on every compared number; a traced bf16 run reads its model FLOPs at the
canvas and the counters ``flow_hole_px`` and ``fgt_px`` at their hand
counts; a planted fault (s4's flowNN filling nothing) moves the check.
"""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from fgt_tpu_torch.pipeline import video_inpainting as vi
from portbench import control, counts, run
from portbench.kinds import infer
from portbench.reference import extrapolation as rx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "outpaint_2x_24f"
N, H, W = 6, 32, 32
CANVAS = (64, 64)


def _load(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


def tiny(precision: str):
    """The cell's configuration and mix at the small size: RAFT big (its
    widths are fixed) with 2 GRU iterations and its flow head at full
    scale (at 2 iterations a tenth moves the flows too little to judge),
    LAFC and FGT at small widths."""
    cfg = copy.deepcopy(_load("configs", "fgt_outpaint_2x_432x240.json"))
    cfg["precision"] = precision
    cfg["raft"]["iters"] = 2
    cfg["lafc"]["cnum"] = 8
    cfg["fgt"].update(cnum=8, flow_cnum=8, frame_hidden=32, flow_hidden=16,
                      numBlocks=2, mlp_ratio=2, sw=4, gd=2, res_h=64,
                      res_w=64)
    cfg["weight_scale"]["raft"] = {}
    cfg["image_hw"], cfg["flow_hw"] = [H, W], [2 * H, 2 * W]
    cfg["canvas_hw"] = list(CANVAS)
    mix = {**_load("traffic", "outpaint_pan_24f.json"), "frames": N,
           "height": H, "width": W, "pool": 2}
    return cfg, mix


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(cfg, mix, limits, trace=False, metrics=(), seed=2 ** 33 + 7):
    return run.run_cell(CELL, {"limits": limits}, cfg, mix, list(metrics),
                        seed, 0.3, trace, "cpu", time.perf_counter())


def _loose():
    return {k: (0 if k == "frame_outside_max" else 1e9)
            for k in _load("workloads", f"{CELL}.json")["limits"]}


def _values(res):
    return {k: v["value"] for k, v in res["checks"].items()}


@pytest.mark.parametrize("scale", [(2.0, 2.0), (1.25, 1.25), (2.0, 1.25)])
def test_reference_canvas_step_equals_the_port(scale):
    rng = np.random.RandomState(3)
    video = rng.rand(N, 30, 42, 3).astype(np.float32)
    ff, fb = (torch.from_numpy(rng.randn(N - 1, 30, 42, 2).astype(
        np.float32)) for _ in range(2))
    got = rx.extrapolation(video, ff, fb, *scale)
    want = vi.extrapolation(video, ff, fb, *scale)
    for a, b in zip(got, want):
        a, b = (x.numpy() if torch.is_tensor(x) else x for x in (a, b))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    ys, xs = rx.centre(30, 42, *got[3].shape)
    assert not got[3][ys, xs].any() and got[3].sum() == got[3].size - 30 * 42


def test_f32_run_reads_zero():
    cfg, mix = tiny("f32")
    res = _run(cfg, mix, _loose(), metrics=["frames_per_s", "setup_s"])
    checks = _values(res)
    print(checks)
    assert res["correct"] and res["attempted"] >= 1
    assert checks["s1_outliers"] == 0 and checks["s2_outliers"] == 0
    assert checks["frame_err"] <= 0.05 and checks["prop_px_share"] == 0
    assert checks["frame_outside_max"] == 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def _fgt_holes(cfg, clip, monkeypatch):
    """The hole pixels the program leaves to FGT on ``clip``, read from
    the argument s6 is called with."""
    seen = []
    fn = vi.fgt_synthesis

    def spy(models, video, masks_u8, *a, **k):
        seen.append(int(masks_u8.count_nonzero()))
        return fn(models, video, masks_u8, *a, **k)
    states = infer.make_states(cfg, cfg["weight_seed"], "cpu")
    models = infer.program_models(cfg, states, "cpu")
    monkeypatch.setattr(vi, "fgt_synthesis", spy)
    vi.inpaint(*clip, models, **cfg["inpaint"])
    return seen[0]


def test_traced_run_reads_flops_at_the_canvas_and_its_counters(monkeypatch):
    from fgt_tpu_torch.utils import profiling
    from portbench import traffic

    cfg, mix = tiny("bf16")
    profiling.reset_spans()
    res = _run(cfg, mix, _loose(), trace=True,
               metrics=["mfu.infer", "flow_hole_px.s2", "fgt_px.s6",
                        "poisson_px.s5", "stage_ms.s6_fgt"])
    got, ctx = res["metrics"], res["ctx"]
    assert got["mfu.infer"]["value"] > 0 and got["stage_ms.s6_fgt"][
        "value"] > 0
    assert ctx["window_flops"] == ctx["items"] * counts.clip_flops(
        cfg["lafc"], cfg["fgt"], N, *CANVAS, cfg["raft"]["iters"])
    ring = CANVAS[0] * CANVAS[1] - H * W
    assert got["flow_hole_px.s2"]["value"] == 2 * (N - 1) * ring
    assert got["poisson_px.s5"]["value"] == N * ring
    # the profiled clip is the pool's first
    clip = traffic.make(mix, 2 ** 33 + 7)[0]
    assert got["fgt_px.s6"]["value"] == _fgt_holes(cfg, clip, monkeypatch)
    assert 0 < got["fgt_px.s6"]["value"] <= N * ring


def test_no_propagation_fault_moves_the_check(monkeypatch):
    """With flowNN filling nothing, s5 solves the whole border from
    zeroed gradients and leaves FGT nothing, where the reference leaves
    it what propagation cannot reach: the frames move off the
    reference's by more than a u8 level a pixel, or the propagated
    pixels by more than the limit's share."""
    cfg, mix = tiny("bf16")
    sound = _values(_run(cfg, mix, _loose()))
    # registered so that the test's end puts the original back
    monkeypatch.setattr(vi, "get_flownn_gradient_frames",
                        vi.get_flownn_gradient_frames)
    control.no_propagation(vi)
    got = _values(_run(cfg, mix, _loose()))
    print(sound, got)
    assert got["frame_err"] - sound["frame_err"] > 1 or \
        got["prop_px_share"] - sound["prop_px_share"] > 0.05
