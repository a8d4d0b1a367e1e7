"""Video-extrapolation cells: one user sends clips back to back through
the port's entry, ``fgt_tpu_torch.pipeline.video_inpainting.inpaint(
frames, None, models, mode="video_extrapolation", h_scale, w_scale)``,
on ``Models(bf16, corr="fused")``, the removal cells' models.

The window runs as :func:`portbench.kinds.infer.run`'s: set-up makes the
weights and the clip pool and runs one cold clip, the window sends clips
until ``seconds`` have passed, and ``frames_per_s`` is every output
frame over the window's seconds. The context's ``kind`` is ``infer``, so
every reader of an inference cell reads this one; a traced run counts
the model FLOPs at the canvas (RAFT's flow resolution is the canvas's
size too, so a clip is counted exactly).

The check (:func:`compare`), once the window has closed: one clip drawn
from the seed among those the window completed is run again through the
entry for its s1 and s2 flows; the program is freed; then the plain
reference (f32, TF32 off) follows the program stage by stage: s1 from
the source frames, s2 from the program's s1 flows placed on the canvas
by the reference's canvas step (:mod:`portbench.reference.extrapolation`),
s3-s6 from the program's completed flows on the canvas frames with the
border as the hole.
"""

from __future__ import annotations

import json
import time

import numpy as np

from portbench import common, traffic
from portbench.kinds import infer


def compare(ref, frames, prog: dict, kw: dict):
    """The numbers compared, and a detail dict for the log. ``prog``
    holds the program's s1 flows (at the frames' size), s2 flows (on the
    canvas), each a (forward, backward) pair, and its output canvas
    frames of one clip; ``ref`` the reference's models; ``kw`` the
    entry's canvas scales. Flows are judged by their outlier share (s2's
    over the border); frames by the mean |difference| (u8 levels) over
    the pixels the reference leaves to FGT, by the share of the pixels
    the reference fills by propagation that differ by more than
    ``infer.PROP_LEVELS``, and, in the centre, by equality with the
    input frames (the program's guarantee)."""
    import torch

    from portbench.reference import extrapolation as rx
    from portbench.reference import pipeline as rp

    dev = ref.device
    n, h, w = frames.shape[:3]
    t0 = time.perf_counter()
    ff, fb = rp.s1_flows(ref, frames.astype(np.float32))
    t_s1 = time.perf_counter()
    want = torch.cat([ff, fb]).cpu().numpy()
    s1_out, s1_epe = infer.flow_errors(np.concatenate(prog["s1"]), want)
    detail = {"s1_epe": s1_epe, "s1_len": float(
        np.sqrt((want.astype(np.float64) ** 2).sum(-1)).mean())}
    pf, pb = (torch.from_numpy(a).to(dev) for a in prog["s1"])
    canvas, pf, pb, border, _ = rx.extrapolation(
        frames.astype(np.float32), pf, pb, kw["h_scale"], kw["w_scale"])
    holes = np.repeat(border[None], n, 0)
    cf, cb = rp.s2_flows(ref, pf, pb, holes, 0)
    where = np.concatenate([holes[:-1], holes[1:]])
    want = torch.cat([cf, cb]).cpu().numpy()[where]
    got = np.concatenate(prog["s2"])[where]
    s2_out, detail["s2_epe"] = infer.flow_errors(got, want)
    detail["s2_rel"] = infer.rel_err(got, want)
    qf, qb = (torch.from_numpy(a).to(dev) for a in prog["s2"])
    t1 = time.perf_counter()
    out, left = rx.s3_s6(ref, canvas, holes, qf, qb)
    common.log(f"reference s1 {t_s1 - t0:.2f} s, s2 {t1 - t_s1:.2f} s, "
               f"s3-s6 {time.perf_counter() - t1:.2f} s")
    diff = np.abs(out.astype(np.int64) - prog["frames"].astype(np.int64))
    fgt_px = left if left.any() else holes
    prop = holes & ~left
    off = diff.max(-1) > infer.PROP_LEVELS
    ys, xs = rx.centre(h, w, *border.shape)
    outside = np.abs(prog["frames"][:, ys, xs].astype(np.int64)
                     - frames.astype(np.int64))
    detail.update(left_share=float(left.sum() / holes.sum()),
                  hole_err=float(diff[holes].mean()),
                  prop_px=int(prop.sum()),
                  prop_px_diff=int((diff.max(-1) > 0)[prop].sum()))
    common.log("detail " + json.dumps(detail))
    return {"s1_outliers": s1_out, "s2_outliers": s2_out,
            "frame_err": float(diff[fgt_px].mean()),
            "prop_px_share": float(off[prop].mean()) if prop.any() else 0.0,
            "frame_outside_max": int(outside.max())}, detail


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float) -> dict:
    """One run of the cell: returns the metrics' context (``ctx``), the
    clips attempted and failed, and the compared numbers beside their
    limits (``checks``)."""
    import torch

    from fgt_tpu_torch.pipeline import video_inpainting as vi

    cuda = torch.device(device).type == "cuda"
    common.log(f"imported {time.perf_counter() - t_start:.2f} s")
    states = infer.make_states(cfg, cfg["weight_seed"], device)
    models = infer.program_models(cfg, states, device)
    common.log(f"models {time.perf_counter() - t_start:.2f} s")
    clips = traffic.make(mix, seed, device)
    common.log(f"clips {time.perf_counter() - t_start:.2f} s")
    kw = cfg["inpaint"]
    clock = common.StageClock(device)
    vi.inpaint(*clips[0], models, timer=common.StageClock(device), **kw)
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
        h, w = cfg["canvas_hw"]     # the model FLOPs of a clip at the canvas
        ctx.update(infer.traced(vi, models, clips, cfg,
                                {**mix, "height": h, "width": w}, clock,
                                lengths))
        common.log(f"traced {time.perf_counter() - t_trace:.2f} s")

    t_check = time.perf_counter()
    j = int(np.random.RandomState(seed % 2 ** 32).randint(n_clips))
    frames, masks = clips[j % len(clips)]
    prog = infer.program_flows(vi, models, frames, masks, kw)
    prog["frames"] = outputs[j]
    del models, outputs
    if cuda:
        torch.cuda.empty_cache()
        infer.f32_exact()
    checks, _ = compare(infer.reference_models(cfg, states, device), frames,
                        prog, kw)
    common.log(f"check {time.perf_counter() - t_check:.2f} s")
    return {"ctx": ctx, "attempted": n_clips, "failed": 0,
            "checks": infer.judge(checks, cell["limits"])}
