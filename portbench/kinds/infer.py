"""Object-removal cells: one user sends clips back to back through the
port's entry, ``fgt_tpu_torch.pipeline.video_inpainting.inpaint``, on
``Models(bf16, corr="fused")``.

Set-up makes the weights (from the configuration's ``weight_seed``)
and the clip pool (from the run's seed) and runs one cold clip. The
window sends clips until ``seconds`` have passed; a clip ends when its
output frames are on the host. ``frames_per_s`` is every
frame of every clip sent in the window over the window's seconds, the
window ending with the last clip.

The entry runs with the settings the configuration's ``inpaint`` states
(the hole dilations). The traced run times the calls the configuration's
``op_ranges`` name at their call boundaries.

The check, once the window has closed and the peak memory is read: one
clip drawn from the seed among those the window completed is run again
through the same entry with ``vis=("flows", "completed_flows")`` (files
under a temporary directory of TMPDIR) to read s1's and s2's flows; the
program is freed; then the plain reference (f32, TF32 off) follows the
program stage by stage from that clip: s1 from the frames, s2 from the
program's s1 flows, s3-s6 from the program's completed flows, against
the window's own output frames.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np

from portbench import common, counts, traffic, weights

# a propagated pixel differs where some channel is off by more than this
# many u8 levels: the program's and the reference's Poisson solves round
# apart by one or two
PROP_LEVELS = 4


def make_states(cfg: dict, seed: int, device) -> dict:
    """RAFT, LAFC and FGT state dicts from the seed, on ``device``."""
    import torch

    from portbench.reference.fgt import FGT
    from portbench.reference.lafc import LAFC
    from portbench.reference.raft import RAFT

    g = torch.Generator(torch.device(device)).manual_seed(seed)
    with torch.device("meta"):
        raft, lafc, fgt = RAFT(), LAFC(cfg["lafc"]), FGT(cfg["fgt"])
    scale = cfg.get("weight_scale", {})
    return {"raft": weights.make_state(raft, weights.raft_std, g,
                                       scale=scale.get("raft")),
            "lafc": weights.make_state(lafc, weights.he("in"), g),
            "fgt": weights.make_state(fgt, weights.normal(0.02), g,
                                      scale=scale.get("fgt"))}


def program_models(cfg: dict, states: dict, device):
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    return vi.Models(device, bf16=cfg["precision"] == "bf16",
                     raft_iters=cfg["raft"]["iters"],
                     lafc_config=cfg["lafc"], fgt_config=cfg["fgt"],
                     raft_state=states["raft"], lafc_state=states["lafc"],
                     fgt_state=states["fgt"], corr=cfg["raft"]["corr"])


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != np.float32(202021.25):
            raise ValueError(f"{path} is not a .flo file")
        w, h = np.frombuffer(f.read(8), np.int32)
        return np.frombuffer(f.read(), np.float32).reshape(h, w, 2).copy()


def read_flo_dir(root: str, sub: str):
    out = []
    for name in ("forward", "backward"):
        d = os.path.join(root, sub, f"{name}_flo")
        out.append(np.stack([read_flo(os.path.join(d, f))
                             for f in sorted(os.listdir(d))]))
    return out


def program_flows(vi, models, frames, masks, kw: dict):
    """s1's and s2's flows of one clip, from the entry's debug outputs."""
    with tempfile.TemporaryDirectory() as root:
        vi.inpaint(frames, masks, models, vis=("flows", "completed_flows"),
                   vis_root=root, **kw)
        return {"s1": read_flo_dir(root, "flow"),
                "s2": read_flo_dir(root, "completed_flow")}


def rel_err(got, want, where=None) -> float:
    """||got - want|| / ||want|| (over ``where`` if given)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if where is not None:
        got, want = got[where], want[where]
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


OUTLIER_PX = 0.25


def flow_errors(got: np.ndarray, want: np.ndarray) -> tuple:
    """(the share of pixels whose end-point error exceeds OUTLIER_PX,
    the mean end-point error in px): KITTI's outlier share, at a
    threshold for flows a few pixels long (KITTI's 3 px is for flows ten
    times as long)."""
    epe = np.sqrt(((got.astype(np.float64) - want) ** 2).sum(-1))
    return float((epe > OUTLIER_PX).mean()), float(epe.mean())


def compare(ref, frames, masks, prog: dict, kw: dict):
    """The numbers compared, and a detail dict for the log. ``prog``
    holds the program's s1 flows, s2 flows (each a (forward, backward)
    pair) and output frames of one clip; ``ref`` the reference's models;
    ``kw`` the entry's hole dilations. Each stage of the reference starts
    from the program's output of the stage before: s1 from the frames, s2
    from the program's s1 flows, s3-s6 from its completed flows. Flows
    are judged by their outlier share (s2's inside its hole); frames by
    the mean |difference| (u8 levels) over the pixels the reference
    leaves to FGT (the hole where propagation left none), by the share
    of the pixels the reference fills by propagation (s4 flowNN, s5
    Poisson) that differ by more than PROP_LEVELS, and, outside the
    hole, by equality with the input (the program's guarantee)."""
    import torch

    from portbench.reference import pipeline as rp

    dev = ref.device
    t0 = time.perf_counter()
    ff, fb = rp.s1_flows(ref, frames.astype(np.float32))
    t_s1 = time.perf_counter()
    want = torch.cat([ff, fb]).cpu().numpy()
    s1_out, s1_epe = flow_errors(np.concatenate(prog["s1"]), want)
    detail = {"s1_epe": s1_epe, "s1_len": float(
        np.sqrt((want.astype(np.float64) ** 2).sum(-1)).mean())}
    pf, pb = (torch.from_numpy(a).to(dev) for a in prog["s1"])
    cf, cb = rp.s2_flows(ref, pf, pb, masks, kw["flow_mask_dilates"])
    hole = rp.flow_masks(masks, kw["flow_mask_dilates"])
    where = np.concatenate([hole[:-1], hole[1:]])
    want = torch.cat([cf, cb]).cpu().numpy()[where]
    got = np.concatenate(prog["s2"])[where]
    s2_out, detail["s2_epe"] = flow_errors(got, want)
    detail["s2_rel"] = rel_err(got, want)
    qf, qb = (torch.from_numpy(a).to(dev) for a in prog["s2"])
    t1 = time.perf_counter()
    out, left = rp.s3_s6(ref, frames.astype(np.float32), masks, qf, qb,
                         kw["frame_dilates"])
    common.log(f"reference s1 {t_s1 - t0:.2f} s, s2 {t1 - t_s1:.2f} s, "
               f"s3-s6 {time.perf_counter() - t1:.2f} s")
    inside = rp.frame_holes(masks, kw["frame_dilates"])
    diff = np.abs(out.astype(np.int64) - prog["frames"].astype(np.int64))
    fgt_px = left if left.any() else inside
    prop = inside & ~left
    off = diff.max(-1) > PROP_LEVELS
    detail.update(left_share=float(left.sum() / inside.sum()),
                  hole_err=float(diff[inside].mean()),
                  prop_px=int(prop.sum()),
                  prop_px_diff=int((diff.max(-1) > 0)[prop].sum()))
    common.log("detail " + json.dumps(detail))
    return {"s1_outliers": s1_out, "s2_outliers": s2_out,
            "frame_err": float(diff[fgt_px].mean()),
            "prop_px_share": float(off[prop].mean()) if prop.any() else 0.0,
            "frame_outside_max": int(diff[~inside].max())}, detail


def reference_models(cfg, states, device):
    from portbench.reference.pipeline import RefModels

    return RefModels(device, cfg["lafc"], cfg["fgt"], states["raft"],
                     states["lafc"], states["fgt"], cfg["raft"]["iters"])


def f32_exact():
    """TF32 off for the reference's products."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def judge(checks: dict, limits: dict) -> dict:
    return {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float) -> dict:
    """One run of the cell: returns the metrics' context (``ctx``), the
    clips attempted and failed, and the compared numbers beside their
    limits (``checks``)."""
    import torch

    from fgt_tpu_torch.pipeline import video_inpainting as vi

    cuda = torch.device(device).type == "cuda"
    common.log(f"imported {time.perf_counter() - t_start:.2f} s")
    states = make_states(cfg, cfg["weight_seed"], device)
    models = program_models(cfg, states, device)
    common.log(f"models {time.perf_counter() - t_start:.2f} s")
    clips = traffic.make(mix, seed, device)
    common.log(f"clips {time.perf_counter() - t_start:.2f} s")
    kw = cfg["inpaint"]
    clock = common.StageClock(device)
    for n in sorted({f.shape[0] for f, _ in clips}):
        # one cold clip of every length the pool sends
        vi.inpaint(*next(c for c in clips if c[0].shape[0] == n), models,
                   timer=common.StageClock(device), **kw)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    common.log(f"set-up {setup_s:.2f} s")

    outputs, lengths, ends = [], [], []
    t0 = time.perf_counter()
    while True:
        frames, masks = clips[len(outputs) % len(clips)]
        outputs.append(vi.inpaint(frames, masks, models, timer=clock, **kw))
        lengths.append(frames.shape[0])
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    window_s = time.perf_counter() - t0
    common.log("clip seconds " + " ".join(
        f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)))
    common.log("stage seconds " + " ".join(
        f"{k} {v:.3f}" for k, v in clock.times.items()))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_clips = len(outputs)
    ctx = {"kind": "infer", "items": n_clips, "frames": sum(lengths),
           "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak}
    common.log(f"window {window_s:.2f} s, {ctx['items']} items")
    if trace:
        t_trace = time.perf_counter()
        ctx.update(traced(vi, models, clips, cfg, mix, clock, lengths))
        common.log(f"traced {time.perf_counter() - t_trace:.2f} s")

    t_check = time.perf_counter()
    j = int(np.random.RandomState(seed % 2 ** 32).randint(n_clips))
    frames, masks = clips[j % len(clips)]
    prog = program_flows(vi, models, frames, masks, kw)
    prog["frames"] = outputs[j]
    del models, outputs
    if cuda:
        torch.cuda.empty_cache()
        f32_exact()
    checks, _ = compare(reference_models(cfg, states, device), frames,
                        masks, prog, kw)
    common.log(f"check {time.perf_counter() - t_check:.2f} s")
    return {"ctx": ctx, "attempted": n_clips, "failed": 0,
            "checks": judge(checks, cell["limits"])}


def traced(vi, models, clips, cfg, mix, clock, lengths) -> dict:
    """What the per-layer metrics read: stage seconds and model FLOPs
    over the un-profiled window (the clips it completed, each counted at
    its length), then a profiled stretch of ``profile_clips`` more clips
    for the rooflines, the idle share and the breakdown."""
    ranges = cfg["op_ranges"]
    stages = dict(clock.times)
    h, w = mix["height"], mix["width"]
    t0 = time.perf_counter()
    per_len = {n: counts.clip_flops(cfg["lafc"], cfg["fgt"], n, h, w,
                                    cfg["raft"]["iters"])
               for n in sorted(set(lengths))}
    common.log(f"flops counted {time.perf_counter() - t0:.2f} s")
    prof_clock = common.StageClock(models.device)
    prof_clock.annotate = True
    with common.OpRanges(common.op_targets(ranges)) as rec:
        prof = common.profile(lambda: [
            vi.inpaint(*clips[i % len(clips)], models, timer=prof_clock,
                       **cfg["inpaint"])
            for i in range(cfg["profile_clips"])])
    t0 = time.perf_counter()
    trace = common.read_trace(prof)
    common.log(f"trace read {time.perf_counter() - t0:.2f} s")
    return {"stages_s": stages,
            "window_flops": sum(per_len[n] for n in lengths),
            "trace": trace, "bound_s": common.op_bounds(ranges, rec.calls)}
