"""Sustained FGT GAN training through the port's real trainer — the
counterpart of the JAX package's ``tools/sustained_train.py``.

Runs ``fgt_tpu_torch.train.trainer.FGTTrainer`` (not the bare step) for
``--steps`` steps at the reference dims (240x432, 5 frames, batch 2,
bf16 mixed precision, the committed model scale, a frozen LAFC-single
flow oracle) over a synthetic YouTube-VOS-style tree, with:

* the in-training DAVIS-protocol validation firing (``train/validate.py``:
  PSNR / SSIM / L1 / L2),
* the metrics stream (``MetricsWriter``, ``tb/metrics.jsonl``),
* the LR decay inside the run: ``UPDATE_INTERVAL`` is ``steps // 2``, so
  the step-decay boundary is crossed mid-run (the reference decays at
  300k of 500k iterations: the same shape, scaled),
* the checkpoint trio (``save_checkpoint_freq``; always at the end).

The tree is the JAX tool's, from the same seeds and the same draws:
textured panning videos whose stored flows are the true pan field plus
noise, JPEG frames (quality 92, 4:2:0; the port's baseline encoder in
place of imageio's) and ``.flo`` flows, so the data path (JPEG decode,
``.flo`` read and resize, mask synthesis, the diffusion fill) runs end
to end. The oracle is a seeded random LAFC-single (no stage-1 weights
ship), saved as a ``state_dict``.

    python -m fgt_tpu_torch.tools.sustained_train [--steps 5000]
        [--videos 8] [--frames 26] [--val_every_steps 1000]
        [--root DIR] [--out FILE] [--device cuda|cpu]

Prints ONE JSON line and writes the full record (with the curves from
the metrics stream) to ``--out``, by default ``<root>/sustained_train.
json`` (never a file of the repository). Beside the JAX record's keys:
the device (the card's name and power limit), peak device memory, the
host data share (the wait before each step, validations and checkpoints
left out, over the wait plus the synchronized step) and the launches of
the flash kernels (K2 forward, K4 / K5 backward) during the run. It runs
on the card unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.core.flow_io import write_flow
from fgt_tpu_torch.core.jpeg_encode import encode_jpeg
from fgt_tpu_torch.models import lafc_single
from fgt_tpu_torch.ops import flash_attention
from fgt_tpu_torch.tools.overfit_gate import box_filter9, card
from fgt_tpu_torch.utils import checkpoint

# the frozen oracle's config (tools/sustained_train.py's flow_cfg)
FLOW_CFG = {"cnum": 48, "in_channel": 3, "PASSMASK": 1, "use_residual": 1,
            "resBlocks": 1, "use_bias": 1, "conv_type": "vanilla"}
# the JAX package's imageio.imwrite(..., quality=92): Pillow's 4:2:0
JPEG_QUALITY = 92
KERNELS = (flash_attention.flash_mhsa, flash_attention.flash_attention_dq,
           flash_attention.flash_attention_dkv)


# ---------------- the synthetic tree ----------------

def video_clips(n_videos: int, n_frames: int, h: int, w: int, flow_h: int,
                flow_w: int, seed: int = 0) -> Iterator[tuple]:
    """Per video, in the JAX tool's draw order: (frames [n, h, w, 3]
    uint8, forward flows [n - 1, flow_h, flow_w, 2] f32). The frames pan
    ``pan`` px a frame over 9x9 box-filtered noise (cv2.filter2D, bit
    for bit); each flow is the pan at flow resolution plus N(0, 0.05)."""
    rng = np.random.RandomState(seed)
    for _ in range(n_videos):
        pan = int(rng.randint(1, 4))
        base = rng.rand(h + 8, w + pan * n_frames + 8, 3) * 255
        base = box_filter9(base.astype(np.float32)).astype(np.uint8)
        frames = np.stack([base[4:4 + h, 4 + pan * i:4 + pan * i + w]
                           for i in range(n_frames)])
        sx = pan * flow_w / float(w)
        flows = []
        for _ in range(n_frames - 1):
            noise = rng.randn(flow_h, flow_w, 2).astype(np.float32) * 0.05
            fwd = noise.copy()
            fwd[..., 0] += -sx
            flows.append(fwd)
        yield frames, np.stack(flows)


def write_video_tree(root: str, n_videos: int, n_frames: int, h: int,
                     w: int, flow_h: int, flow_w: int,
                     seed: int = 0) -> None:
    """``frames/<video>/%05d.jpg`` and ``flows/<video>/{forward,
    backward}_flo/%05d.flo`` (backward = -forward): the YouTube-VOS
    layout the trainers read, as the JAX tool's ``_write_video_tree``
    writes it."""
    clips = video_clips(n_videos, n_frames, h, w, flow_h, flow_w, seed)
    for v, (frames, flows) in enumerate(clips):
        name = f"video{v:03d}"
        fdir = os.path.join(root, "frames", name)
        xdir = os.path.join(root, "flows", name)
        os.makedirs(fdir, exist_ok=True)
        for d in ("forward_flo", "backward_flo"):
            os.makedirs(os.path.join(xdir, d), exist_ok=True)
        for i, frame in enumerate(frames):
            with open(os.path.join(fdir, f"{i:05d}.jpg"), "wb") as f:
                f.write(encode_jpeg(frame, JPEG_QUALITY, "420"))
        for i, fwd in enumerate(flows):
            write_flow(fwd, os.path.join(xdir, "forward_flo",
                                         f"{i:05d}.flo"))
            write_flow(-fwd, os.path.join(xdir, "backward_flo",
                                          f"{i:05d}.flo"))


def write_oracle(path: str, flow_cfg: dict, seed: int = 2) -> None:
    """A seeded random LAFC-single at ``flow_cfg``, as a ``state_dict``
    (the ORACLE CALL is what the run exercises, not its weights)."""
    model = lafc_single.init_lafc_single(
        lafc_single.Model(flow_cfg), torch.Generator().manual_seed(seed))
    checkpoint.save(model.state_dict(), path)


# ---------------- the run ----------------

def build_opt(args, root: str, oracle_path: str) -> dict:
    """The trainer's ``opt``: the JAX tool's dict (its paths under
    ``root``), with ``val_freq`` in epochs from ``--val_every_steps``
    (validation fires at the end of an epoch of ceil(videos / batch)
    loader steps)."""
    h, w = args.imgH, args.imgW
    val_root = os.path.join(root, "val")
    steps = args.steps
    opt = {
        "name": "FGT_sustained_r05", "model": "model",
        "outputdir": os.path.join(root, "outputs"),
        "datasetName_train": "train_dataset",
        "seed": 10, "mixed_precision": 1, "record_iter": 16,
        "use_valid": True,
        "datasets": {
            "dataInfo": {
                "frame_path": os.path.join(root, "frames"),
                "flow_path": os.path.join(root, "flows"),
                "name2len": None,
                "flow": {"flow_height": h, "flow_width": w},
                "edge": {"sigma": 1, "low_threshold": 0.1,
                         "high_threshold": 0.2},
            },
            "valInfo": {
                "frame_root": os.path.join(val_root, "frames"),
                "flow_root": os.path.join(val_root, "flows"),
                "num_videos": 4, "input_resolution": [h, w],
                "pivot": 12,
            },
            "train": {"batch_size": args.batch, "n_workers": args.workers},
        },
        "train": {
            "lr": 1e-4, "lr_decay": 0.1, "BETA1": 0.9, "BETA2": 0.999,
            "MAX_ITERS": steps,
            "UPDATE_INTERVAL": max(1, steps // 2),
            "WARMUP": None,
            "log_freq": 16, "save_checkpoint_freq": max(500, steps // 2),
            "L1M": 1, "L1V": 1, "adv": 0.01,
        },
        "flow_checkPoint": oracle_path,
        "flow_config": dict(FLOW_CFG),
        "flow_direction": "for", "num_frames": 5, "sample": "random",
        "input_resolution": (h, w),
        # the reference model scale (FGT/config/train.yaml:58-85)
        "res_h": h, "res_w": w, "in_channel": 4, "cnum": 64,
        "flow_inChannel": 2, "flow_cnum": 64, "dist_cnum": 32,
        "frame_hidden": 512, "flow_hidden": 256, "PASSMASK": 1,
        "numBlocks": 8, "kernel_size_w": 7, "kernel_size_h": 7,
        "stride_h": 3, "stride_w": 3, "pad_h": 3, "pad_w": 3,
        "num_head": 4, "conv_type": "vanilla", "norm": None,
        "use_bias": 1, "ape": 1, "mlp_ratio": 40, "drop": 0, "tw": 2,
        "sw": 8, "gd": 4, "ref_length": 10, "path": {}, "resume": False,
    }
    iters_per_epoch = max(1, -(-args.videos // args.batch))
    opt["train"]["val_freq"] = max(1, args.val_every_steps
                                   // iters_per_epoch)
    return opt


class StepClock:
    """Times a trainer's steps on the instance: per step the host's wait
    before it (the loader; validations and checkpoints between two steps
    left out) and the step itself, synchronized on the card; and each
    validation and checkpoint."""

    def __init__(self, trainer):
        self.waits, self.steps, self.vals, self.saves = [], [], [], []
        self._last, self._between = None, 0.0
        on_card = trainer.device.type == "cuda"
        self._sync = torch.cuda.synchronize if on_card else (lambda: None)
        step, validate = trainer._train_step, trainer._validate
        save = trainer.save_checkpoint

        def timed_step(batch):
            t0 = time.perf_counter()
            if self._last is not None:
                self.waits.append(t0 - self._last - self._between)
            out = step(batch)
            self._sync()
            self._last = time.perf_counter()
            self._between = 0.0
            self.steps.append(self._last - t0)
            return out

        def between(fn, spans):
            def call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                self._sync()
                spans.append(time.perf_counter() - t0)
                self._between += spans[-1]
                return out
            return call

        trainer._train_step = timed_step
        trainer._validate = between(validate, self.vals)
        trainer.save_checkpoint = between(save, self.saves)

    def host_data_share(self) -> Optional[float]:
        """Wait / (wait + step) over the steps after the first two (the
        cold ones)."""
        waits, steps = self.waits[1:], self.steps[2:]
        if not waits:
            return None
        return float(sum(waits) / (sum(waits) + sum(steps)))


def run(opt: dict, device: str):
    """Build the trainer, train to ``MAX_ITERS``. Returns (trainer,
    clock, init seconds, train seconds, launches of K2, K4, K5)."""
    from fgt_tpu_torch.train.trainer import FGTTrainer

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = FGTTrainer(opt, device=device)
    init_s = time.perf_counter() - t0
    clock = StepClock(trainer)
    before = [k.launches for k in KERNELS]
    t0 = time.perf_counter()
    trainer.train()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches - b for k, b in zip(KERNELS, before)}
    return trainer, clock, init_s, wall, launches


def summarize(trainer, args, wall: float, init_s: float, datagen_s: float,
              clock: StepClock, launches: dict) -> dict:
    """The record, from the run's own metrics stream: the JAX tool's keys
    (metric name, steps/s, validations by step, the LR at the first and
    last log and whether it decayed, the first and last ``gen_loss``
    means, the ``dis_loss`` range over the second half, the checkpoints,
    the curves), then the port's (see the module doc)."""
    h, w, steps = args.imgH, args.imgW, args.steps
    with open(trainer.metrics.path) as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if "gen_loss" in r]
    val_rows = [r for r in rows if any(k.startswith("val/") for k in r)]
    lrs = [(r["step"], r["lr"]) for r in train_rows if "lr" in r]
    gl = [r["gen_loss"] for r in train_rows]
    dl = [r["dis_loss"] for r in train_rows]
    half = len(dl) // 2
    ckpts = sorted(os.listdir(os.path.join(trainer.run_dir, "checkpoints")))
    on_card = trainer.device.type == "cuda"
    share = clock.host_data_share()
    rec = {
        "metric": f"fgt_trainer_sustained_{steps}steps_{h}x{w}"
                  f"_b{args.batch}_bf16",
        "value": round(steps / wall, 3), "unit": "steps/s",
        "vs_baseline": 0.0,
        "steps": steps, "wall_s": round(wall, 1),
        "init_s": round(init_s, 1), "datagen_s": round(datagen_s, 1),
        "videos": args.videos,
        "global_batch": trainer.train_loader.batch_size * trainer.mesh.dp,
        "validations": [
            {"step": r["step"],
             **{k.split("/", 1)[1]: round(v, 4) for k, v in r.items()
                if k.startswith("val/")}} for r in val_rows],
        "lr_first": lrs[0][1] if lrs else None,
        "lr_last": lrs[-1][1] if lrs else None,
        "lr_decayed": bool(lrs and lrs[-1][1] < lrs[0][1] * 0.5),
        "gen_loss_first_mean": round(float(np.mean(gl[:4])), 4),
        "gen_loss_last_mean": round(float(np.mean(gl[-4:])), 4),
        "dis_loss_last_half_min": round(float(np.min(dl[half:])), 4),
        "dis_loss_last_half_max": round(float(np.max(dl[half:])), 4),
        "checkpoints": ckpts,
        "run_dir": trainer.run_dir,
        **card(str(trainer.device)),
        "losses_finite": bool(all(np.isfinite(v) for r in train_rows
                                  for k, v in r.items()
                                  if k not in ("step", "time"))),
        "peak_gib": (round(torch.cuda.max_memory_allocated() / 2 ** 30, 3)
                     if on_card else None),
        "launches": launches,
        "host_data_share": None if share is None else round(share, 4),
        "wait_ms": round(1e3 * float(np.mean(clock.waits[1:] or [0])), 2),
        "step_ms": round(1e3 * float(np.mean(clock.steps[2:] or [0])), 2),
        "validation_s": [round(s, 2) for s in clock.vals],
        "checkpoint_s": [round(s, 2) for s in clock.saves],
        "curves": {
            "step": [r["step"] for r in train_rows],
            "gen_loss": [round(r["gen_loss"], 4) for r in train_rows],
            "dis_loss": [round(r["dis_loss"], 4) for r in train_rows],
            "lr": [r.get("lr") for r in train_rows],
            "it_per_s": [round(r.get("it_per_s", 0.0), 3)
                         for r in train_rows],
        },
    }
    return rec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--videos", type=int, default=8)
    p.add_argument("--frames", type=int, default=26)
    p.add_argument("--imgH", type=int, default=240)
    p.add_argument("--imgW", type=int, default=432)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--val_every_steps", type=int, default=1000)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "fgt_sustained"),
                   help="the synthetic trees, the oracle and the run "
                        "(trees and oracle are reused when present)")
    p.add_argument("--out", default=None,
                   help="the JSON record (default <root>/sustained_train."
                        "json)")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    return p


def require_device(device: str) -> None:
    """No fallback: a CUDA device that is not there raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device here (pass "
                           f"--device cpu to train on the CPU)")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    require_device(args.device)
    h, w = args.imgH, args.imgW
    root = args.root
    t0 = time.perf_counter()
    if not os.path.isdir(os.path.join(root, "frames")):
        write_video_tree(root, args.videos, args.frames, h, w, h // 2,
                         w // 2, seed=0)
    val_root = os.path.join(root, "val")
    if not os.path.isdir(os.path.join(val_root, "frames")):
        write_video_tree(val_root, 4, 25, h, w, h // 2, w // 2, seed=99)
    datagen_s = time.perf_counter() - t0
    oracle_path = os.path.join(root, "lafc_single.pth")
    opt = build_opt(args, root, oracle_path)
    if not os.path.exists(oracle_path):
        write_oracle(oracle_path, opt["flow_config"])
    trainer, clock, init_s, wall, launches = run(opt, args.device)
    rec = summarize(trainer, args, wall, init_s, datagen_s, clock, launches)
    out = args.out or os.path.join(root, "sustained_train.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "curves"}),
          flush=True)
    return rec


if __name__ == "__main__":
    main()
