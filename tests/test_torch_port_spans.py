"""The port's spans and counters (``fgt_tpu_torch/utils/profiling.py``)
on the CPU at tiny sizes: off they record nothing and build nothing;
under ``torch.profiler`` a clip and two GAN steps record their stages
and phases with the right parents, one root each, in the profiler's
clock; ``pcg_iters``, ``pcg_syncs`` and ``poisson_px`` agree with
counts taken apart from the program. One test, marked ``cuda``, checks ``device_ms`` on a
card and skips elsewhere."""

import json

import numpy as np
import pytest
import scipy.ndimage
import torch
from torch.autograd import DeviceType

from fgt_tpu_torch.models import discriminator as tdisc
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc_single as tls
from fgt_tpu_torch.ops import diffusion
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from fgt_tpu_torch.train import fgt_step as tfs
from fgt_tpu_torch.train.schedules import make_adam
from fgt_tpu_torch.utils import profiling

TINY_LAFC = {"model": "lafc", "num_flows": 3, "flow_interval": 3, "cnum": 8,
             "in_channel": 3, "PASSMASK": 1, "use_residual": 1,
             "resBlocks": 1, "use_bias": 1, "conv_type": "vanilla",
             "use_edges": 0}
TINY_FGT = {
    "model": "model", "in_channel": 4, "cnum": 8, "flow_inChannel": 2,
    "flow_cnum": 8, "frame_hidden": 32, "flow_hidden": 16, "PASSMASK": 1,
    "numBlocks": 2, "num_head": 4, "conv_type": "vanilla", "norm": None,
    "use_bias": 1, "ape": 1, "mlp_ratio": 2, "drop": 0, "tw": 2, "sw": 4,
    "gd": 2, "kernel_size_w": 7, "kernel_size_h": 7, "stride_h": 3,
    "stride_w": 3, "pad_h": 3, "pad_w": 3, "res_h": 32, "res_w": 32,
}
TINY_ORACLE = {"cnum": 8, "in_channel": 3, "PASSMASK": 1,
               "use_residual": 1, "resBlocks": 1, "use_bias": 1,
               "conv_type": "vanilla"}

STAGES = ("s1_raft", "s2_lafc", "s3_gradients", "s4_flownn", "s5_poisson",
          "s6_fgt")
PHASES = ("oracle", "g_forward", "d_update", "g_backward", "g_adam")
INPAINT_KW = dict(flow_mask_dilates=1, neighbor_stride=2, step=2)


def _video(n=4, h=32, w=32, seed=0):
    """Smoothed noise panning 2 px a frame, a square hole moving with
    it."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h, w + 2 * n, 3).astype(np.float32) * 255
    base = scipy.ndimage.uniform_filter(base, size=(5, 5, 1)).astype(np.uint8)
    frames = np.stack([base[:, 2 * i:2 * i + w] for i in range(n)])
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        masks[i, h * 3 // 8:h * 5 // 8, w // 4 + i:w // 4 + i + h // 4] = 1
    return frames, masks


def _models():
    return tvi.Models("cpu", bf16=False, raft_iters=1, lafc_config=TINY_LAFC,
                      fgt_config=TINY_FGT)


def _step():
    torch.manual_seed(0)
    gen = tfgt.Model(TINY_FGT)
    disc = tdisc.TemporalPatchGAN(3, 4)
    oracle = tls.Model(TINY_ORACLE).eval().requires_grad_(False)
    return tfs.FGTTrainStep(gen, disc, oracle, make_adam(gen.parameters()),
                            make_adam(disc.parameters()), lambda s: 1e-4,
                            mixed_precision=True)


def _batch(b=1, t=3, h=32, w=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    masks = torch.zeros(b, t, h, w, 1)
    masks[:, :, 10:20, 8:22] = 1.0
    return {"frames": torch.rand(b, t, h, w, 3, generator=g) * 2 - 1,
            "masks": masks,
            "flows": torch.randn(b, t, h, w, 2, generator=g)}


def _profiled(fn):
    """``fn()`` under a CPU profiler from an empty span list: the spans
    and the profiler's CPU ranges by name, each list in start order."""
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    ranges: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            ranges.setdefault(e.name(), []).append(e.start_ns())
    return profiling.spans(), {k: sorted(v) for k, v in ranges.items()}


@pytest.fixture(scope="module")
def clip():
    """One tiny clip under the profiler, with the unknowns each
    ``poisson_blend`` call was handed and the top-level V-cycles of the
    device diffusion counted outside the program."""
    frames, masks = _video()
    models = _models()
    holes, cycles = [], []
    blend, vcycle = tvi.poisson_blend, diffusion._vcycle

    def counted_blend(img, gx, gy, hole, fill):
        holes.append(int(np.asarray(hole, bool).sum()))
        return blend(img, gx, gy, hole, fill)

    def counted_vcycle(r, masks, level=0, *a, **k):
        cycles.append(level)
        return vcycle(r, masks, level, *a, **k)

    tvi.poisson_blend, diffusion._vcycle = counted_blend, counted_vcycle
    try:
        recs, ranges = _profiled(
            lambda: tvi.inpaint(frames, masks, models, **INPAINT_KW))
    finally:
        tvi.poisson_blend, diffusion._vcycle = blend, vcycle
    return recs, ranges, sum(holes), cycles.count(0)


@pytest.fixture(scope="module")
def steps():
    step, batch = _step(), _batch()
    return _profiled(lambda: [step(batch) for _ in range(2)])


def _by_id(recs):
    return {r["id"]: r for r in recs}


def test_off_span_is_the_shared_no_op_and_builds_nothing(monkeypatch):
    """With no profiler and spans not enabled, a clip and a step record
    nothing, build no span, open no range and create no CUDA event."""
    def refuse(*a, **k):
        raise AssertionError("built while spans are off")

    profiling.enable_spans(False)
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("x") is profiling.span("y", device="cpu")
    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    profiling.reset_spans()
    frames, masks = _video()
    tvi.inpaint(frames, masks, _models(), **INPAINT_KW)
    step = _step()
    step(_batch())
    with profiling.span("x"):
        profiling.count("n", 1)
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_clip_records_its_stages_under_one_root(clip):
    recs, _, _, _ = clip
    ids = _by_id(recs)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["inpaint"]
    root = roots[0]
    assert root["attrs"] == {"frames": 4}
    assert all(r["root"] == root["id"] for r in recs)
    stages = [r["name"] for r in recs if r["parent"] == root["id"]]
    assert stages == list(STAGES)
    want = {"s1.encode": "s1_raft", "s1.refine": "s1_raft",
            "s2.diffusion": "s2_lafc", "s2.lafc_net": "s2_lafc",
            "s6.forward": "s6_fgt", "s6.composite": "s6_fgt"}
    inner = [r for r in recs if r["parent"] not in (None, root["id"])]
    assert {r["name"] for r in inner} == set(want)
    for r in inner:
        assert ids[r["parent"]]["name"] == want[r["name"]]
        assert r["start_ns"] >= ids[r["parent"]]["start_ns"]
        assert r["end_ns"] <= ids[r["parent"]]["end_ns"]
    names = [r["name"] for r in inner]
    # both flow directions in s2; one window batch in s6
    assert names.count("s2.diffusion") == names.count("s2.lafc_net") == 2
    assert names.count("s6.forward") == names.count("s6.composite") == 1
    # no card: no device interval
    assert all(r["device_ms"] is None for r in recs)
    assert not any(r["name"].startswith("pb.") for r in recs)


def test_steps_record_their_phases_one_root_each(steps):
    recs, _ = steps
    ids = _by_id(recs)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["fgt_step"] * 2
    assert [r["attrs"]["step"] for r in roots] == [0, 1]
    for root in roots:
        mine = [r for r in recs if r["root"] == root["id"]]
        phases = [r["name"] for r in mine if r["parent"] == root["id"]]
        assert phases == list(PHASES)
        casts = [ids[r["parent"]]["name"] for r in mine
                 if r["name"] == "cast"]
        assert casts == ["oracle", "g_forward"]
        assert len(mine) == 1 + len(PHASES) + 2


@pytest.mark.parametrize("run", ["clip", "steps"])
def test_span_starts_share_the_profiler_clock(run, request):
    """Each span's stored start lies within 1 ms of its range's
    ``start_ns()`` in the profiler's own events."""
    recs, ranges = request.getfixturevalue(run)[:2]
    by_name: dict = {}
    for r in recs:
        by_name.setdefault(r["name"], []).append(r["start_ns"])
    assert len(by_name) >= 6
    for name, starts in by_name.items():
        assert len(ranges[name]) == len(starts), name
        worst = max(abs(a - b) for a, b in zip(starts, ranges[name]))
        assert worst < 1_000_000, (name, worst)


def test_clip_counters_agree_with_independent_counts(clip):
    recs, _, hole_px, top_cycles = clip
    pcg = [r["counters"]["pcg_iters"] for r in recs
           if r["name"] == "s2.diffusion"]
    # a solve runs one V-cycle before its loop and one per iteration
    assert len(pcg) == 2 and all(n > 0 for n in pcg)
    assert sum(pcg) == top_cycles - 2
    s5 = [r for r in recs if r["name"] == "s5_poisson"]
    # the CPU's splu loop: no CG iterations
    assert hole_px > 0 and s5[0]["counters"] == {"poisson_px": hole_px,
                                                 "poisson_iters": 0}


def test_pcg_iters_counts_the_loop_on_one_hole(monkeypatch):
    plane = torch.rand(1, 40, 48, generator=torch.Generator().manual_seed(1))
    hole = torch.zeros(1, 40, 48)
    hole[:, 12:26, 15:33] = 1
    cycles = []
    vcycle = diffusion._vcycle

    def counted(r, masks, level=0, *a, **k):
        cycles.append(level)
        return vcycle(r, masks, level, *a, **k)

    monkeypatch.setattr(diffusion, "_vcycle", counted)
    profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        with profiling.span("solve"):
            diffusion.laplace_fill_planes(plane, hole)
    finally:
        profiling.enable_spans(False)
    (rec,) = profiling.spans()
    # one V-cycle before the loop, one per iteration
    assert cycles.count(0) == 1 + rec["counters"]["pcg_iters"]
    assert 0 < rec["counters"]["pcg_iters"] < diffusion.MAX_ITERS


def test_pcg_syncs_reads_the_flag_once_an_iteration_on_the_cpu():
    from portbench import common

    plane = torch.rand(2, 40, 48, generator=torch.Generator().manual_seed(3))
    hole = torch.zeros(2, 40, 48)
    hole[:, 10:30, 12:36] = 1
    profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        with profiling.span("inpaint"):
            with profiling.span("s2.diffusion"):
                diffusion.laplace_fill_planes(plane, hole)
    finally:
        profiling.enable_spans(False)
    root, solve = profiling.spans()
    counters = solve["counters"]
    # the plain version reads the flag before every iteration and once
    # more to stop
    assert 0 < counters["pcg_iters"] < diffusion.MAX_ITERS
    assert counters["pcg_syncs"] == counters["pcg_iters"] + 1
    ctx = {"kind": "infer", "trace": {}}
    assert common.metric_reader("pcg_syncs.s2")(ctx) == (
        counters["pcg_syncs"], "syncs/clip")
    assert common.metric_reader("pcg_iters.s2")(ctx) == (
        counters["pcg_iters"], "iterations/clip")
    assert common.metric_reader("pcg_syncs.s2")({"kind": "train",
                                                 "trace": {}}) is None


def test_poisson_px_counts_the_unknowns():
    from fgt_tpu_torch.pipeline.poisson import poisson_blend

    rng = np.random.RandomState(2)
    img = rng.rand(20, 24, 3)
    hole = np.zeros((20, 24), bool)
    hole[5:11, 6:15] = True
    hole[14:17, 2:4] = True
    profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        with profiling.span("s5"):
            poisson_blend(img, np.zeros((20, 23, 3)), np.zeros((19, 24, 3)),
                          hole, np.zeros_like(hole))
            poisson_blend(img, np.zeros((20, 23, 3)), np.zeros((19, 24, 3)),
                          np.zeros_like(hole), np.zeros_like(hole))
    finally:
        profiling.enable_spans(False)
    (rec,) = profiling.spans()
    assert rec["counters"] == {"poisson_px": int(hole.sum())}


def test_records_are_bounded_and_drops_counted():
    profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        for _ in range(profiling.MAX_SPANS + 5):
            with profiling.span("x"):
                pass
    finally:
        profiling.enable_spans(False)
    assert profiling.dropped_spans() == 5
    recs = profiling.spans()
    assert len(recs) == profiling.MAX_SPANS
    assert recs[0]["id"] == recs[-1]["id"] - profiling.MAX_SPANS + 1
    profiling.reset_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_cli_profile_writes_spans_in_the_trace_base(tmp_path):
    """``--profile DIR``: trace.json holds the spans as ranges and
    spans.jsonl their records, whose starts lie within 1 ms of the
    ranges' in the trace's base (``baseTimeNanoseconds`` + ``ts``)."""
    from fgt_tpu_torch.pipeline import image_io

    frames, masks = _video(seed=4)
    for sub in ("frames", "masks", "lafc", "fgt"):
        (tmp_path / sub).mkdir()
    for i, (fr, m) in enumerate(zip(frames, masks)):
        image_io.write_png(str(tmp_path / "frames" / f"{i:05d}.png"), fr)
        image_io.write_png(str(tmp_path / "masks" / f"{i:05d}.png"), m * 255)
    for sub, cfg in (("lafc", TINY_LAFC), ("fgt", TINY_FGT)):
        with open(tmp_path / sub / "config.json", "w") as f:
            json.dump(cfg, f)
    torch.save({"model_state_dict": tfgt.Model(TINY_FGT).state_dict()},
               tmp_path / "fgt" / "fgt.pth")
    prof = tmp_path / "prof"
    tvi.main([
        "--path", str(tmp_path / "frames"), "--path_mask",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "out"),
        "--lafc_ckpts", str(tmp_path / "lafc"), "--fgt_ckpts",
        str(tmp_path / "fgt"), "--raft_model", "/nonexistent",
        "--imgH", "32", "--imgW", "32", "--raft_iters", "1",
        "--flow_mask_dilates", "1", "--neighbor_stride", "2", "--step", "2",
        "--f32", "--device", "cpu", "--profile", str(prof)])
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    with open(prof / "spans.jsonl") as f:
        recs = [json.loads(line) for line in f]
    names = [r["name"] for r in recs]
    assert {"s0_init", "s0_load_frames", "inpaint", "s7_write",
            *STAGES} <= set(names)
    assert names.count("inpaint") == 1
    base = trace["baseTimeNanoseconds"]
    starts: dict = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            starts.setdefault(e["name"], []).append(base + e["ts"] * 1e3)
    for name in set(names):
        mine = sorted(r["start_ns"] for r in recs if r["name"] == name)
        theirs = sorted(starts[name])
        assert len(mine) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1e6, name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device_ms comes from CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_ms_is_filled_on_the_card(card):
    plane = torch.rand(8, 240, 432, device=card)
    hole = torch.zeros(8, 240, 432, device=card)
    hole[:, 60:180, 100:300] = 1
    profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        with profiling.span("root", device=card):
            with profiling.span("solve"):
                diffusion.laplace_fill_planes(plane, hole)
    finally:
        profiling.enable_spans(False)
    root, solve = profiling.spans()
    assert (root["name"], solve["parent"]) == ("root", root["id"])
    assert 0 < solve["device_ms"] <= root["device_ms"]
    assert solve["counters"]["pcg_iters"] > 0
