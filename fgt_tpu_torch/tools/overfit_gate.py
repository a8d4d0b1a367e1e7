"""Overfit quality gate of the port: training must improve the port's own
inpainting — the counterpart of the JAX package's ``tools/overfit_gate.py``.

No pretrained weights or real videos ship with the repository, so no
absolute quality can be shown. What can: start from random weights, run
object removal through the inference CLI on a synthetic clip (PSNR
before), overfit LAFC on smooth pan flows and FGT on the clip's own
frames with the port's training steps, run the CLI again with the
trained checkpoint directories (PSNR after), and require the PSNR to
rise. Two protocols, as the JAX tool's:

* full recipe: ``bench.py``'s synthetic pan clip (smoothed noise panning
  2 px a frame, a 56x56 hole moving with it), LAFC ``--lafc_steps`` and
  FGT ``--fgt_steps`` steps, PSNR over whole frames;
* ``--fgt_only``: a static camera and a static hole, which no flow chain
  reaches, so the hole-region PSNR before and after ``--fgt_steps`` FGT
  steps (LAFC left random) measures what FGT learned.

Scores come from the PNG frames the CLI writes. The steps run in f32, as
the JAX tool's; on the card the FGT step launches the flash kernels (K2,
K4, K5) and inference launches K1 and K2, as everywhere in the port.

    python -m fgt_tpu_torch.tools.overfit_gate [--fgt_only]
        [--lafc_steps 150] [--fgt_steps 100] [--frames 24]
        [--out overfit_gate_torch.json] [--device cuda] [--keep]

The record is merged into ``--out`` (the full recipe's keys at the top
level, ``--fgt_only``'s under ``fgt_only``); the exit status is 1 when
the protocol did not improve.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.core import metrics
from fgt_tpu_torch.models import discriminator, fgt, lafc
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline import video_inpainting as vi
from fgt_tpu_torch.train.fgt_step import FGTTrainStep
from fgt_tpu_torch.train.lafc_step import LAFCTrainStep
from fgt_tpu_torch.train.schedules import make_adam, warmup_step_decay
from fgt_tpu_torch.utils import checkpoint

H, W = 240, 432
LR = 2e-4
LOG_EVERY = 25            # loss curve: step 1, then every 25 steps


# ---------------- data ----------------

def box_filter9(img: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(img, -1, np.ones((9, 9), np.float32) / 81)`` on a
    float32 [H, W, C] image, bit for bit: BORDER_REFLECT_101, and each
    output a chain of 81 fused multiply-adds in the kernel's row-major
    tap order from 0 (f32 products and sums, each rounded once; exact in
    f64 here, since a product of two f32 values and its f32 addend fit
    53 bits)."""
    k = np.float64((np.ones((9, 9), np.float32) / np.float32(81.0))[0, 0])
    h, w = img.shape[:2]
    pad = np.pad(np.asarray(img, np.float32), ((4, 4), (4, 4), (0, 0)),
                 mode="reflect")
    acc = np.zeros(img.shape, np.float32)
    for ky in range(9):
        for kx in range(9):
            tap = pad[ky:ky + h, kx:kx + w].astype(np.float64)
            acc = (tap * k + acc).astype(np.float32)
    return acc


def _write_clip(root: str, frames, masks):
    frames_dir = os.path.join(root, "frames")
    masks_dir = os.path.join(root, "masks")
    os.makedirs(frames_dir, exist_ok=True)
    os.makedirs(masks_dir, exist_ok=True)
    for i, (frame, mask) in enumerate(zip(frames, masks)):
        image_io.write_png(os.path.join(frames_dir, f"{i:05d}.png"), frame)
        image_io.write_png(os.path.join(masks_dir, f"{i:05d}.png"), mask)
    return frames_dir, masks_dir


def make_synthetic_data(root: str, n: int = 24, h: int = H, w: int = W):
    """``bench.make_synthetic_data``: smoothed noise panning 2 px a frame
    and a 56x56 hole moving with it, as PNG directories under ``root``.
    Returns (frames_dir, masks_dir)."""
    rng = np.random.RandomState(0)
    pan = 2
    base = (rng.rand(h + 8, w + pan * n + 8, 3) * 255).astype(np.uint8)
    base = box_filter9(base.astype(np.float32)).astype(np.uint8)
    frames, masks = [], []
    for i in range(n):
        frames.append(base[4:4 + h, 4 + pan * i:4 + pan * i + w])
        mask = np.zeros((h, w), np.uint8)
        y, x = 90, 160 + pan * i
        mask[y:y + 56, x:x + 56] = 255
        masks.append(mask)
    return _write_clip(root, frames, masks)


def make_static_data(root: str, n: int, h: int = H, w: int = W):
    """The JAX tool's ``make_static_data``: a static smoothed-noise frame
    with a little per-frame jitter (so the discriminator's task is not
    degenerate) and a static 56x56 hole that no frame reveals. Returns
    (frames_dir, masks_dir)."""
    rng = np.random.RandomState(7)
    base = box_filter9((rng.rand(h, w, 3) * 255).astype(np.float32))
    mask = np.zeros((h, w), np.uint8)
    mask[92:148, 188:244] = 255
    frames = []
    for _ in range(n):
        jit = rng.randn(h, w, 3).astype(np.float32) * 1.5
        frames.append(np.clip(base + jit, 0, 255).astype(np.uint8))
    return _write_clip(root, frames, [mask] * n)


def lafc_batch(i: int, h: int, w: int, t: int = 3,
               pan: float = 2.0) -> dict:
    """The JAX tool's LAFC batch of step ``i``: 4 copies of a smooth
    pan-like flow, 72x72 holes at staggered places, noise in the holes of
    the diffused flows, a random frame and its copy shifted by the pan."""
    rng = np.random.RandomState(i % 8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    b = 4
    base = np.stack([xx * 0 + pan + 0.3 * np.sin(yy / 53.0 + i % 8),
                     yy * 0 + 0.3 * np.cos(xx / 47.0 - i % 8)], -1)
    flows = np.broadcast_to(base, (b, t, h, w, 2)).astype(np.float32)
    masks = np.zeros((b, t, h, w, 1), np.float32)
    for j in range(b):
        y0, x0 = 40 + 13 * j, 100 + 17 * j
        masks[j, :, y0:y0 + 72, x0:x0 + 72] = 1.0
    diffused = flows * (1 - masks) + \
        rng.randn(*flows.shape).astype(np.float32) * masks * 0.5
    cur = rng.rand(b, h, w, 3).astype(np.float32)
    return {"flows": flows.copy(), "diffused_flows": diffused,
            "masks": masks, "edges": np.zeros((b, h, w, 1), np.float32),
            "current_frame": cur,
            "shift_frame": np.roll(cur, int(pan), 2)}


def load_clip(frames_dir: str, h: int, w: int) -> np.ndarray:
    """[N, h, w, 3] float32 in [-1, 1]: the PNG frames, float-resized."""
    frames = image_io.read_stack(frames_dir, "unchanged")
    return image_io.resize_linear(frames.astype(np.float32), h, w) \
        / 255.0 * 2 - 1


def fgt_batch(i: int, clip: np.ndarray, h: int, w: int, t: int = 5,
              pan: float = 2.0) -> dict:
    """The JAX tool's FGT batch of step ``i``: 2 windows of ``t`` frames
    at random starts, a random 72x72 hole each, constant pan flows."""
    rng = np.random.RandomState(i % 8)
    b = 2
    n = clip.shape[0]
    frames = np.stack([clip[s:s + t] for s in rng.randint(0, n - t, size=b)])
    masks = np.zeros((b, t, h, w, 1), np.float32)
    for j in range(b):
        y0 = rng.randint(30, h - 90)
        x0 = rng.randint(30, w - 90)
        masks[j, :, y0:y0 + 72, x0:x0 + 72] = 1.0
    flows = np.zeros((b, t, h, w, 2), np.float32)
    flows[..., 0] = pan
    return {"frames": frames, "masks": masks, "flows": flows}


# ---------------- models and training ----------------

def random_models(lafc_cfg: dict, fgt_cfg: dict, seed: int = 0):
    """LAFC and FGT at their seeded random init (f32, on the CPU)."""
    return (lafc.init_lafc(lafc.Model(lafc_cfg),
                           torch.Generator().manual_seed(seed)),
            fgt.init_fgt(fgt.Model(fgt_cfg),
                         torch.Generator().manual_seed(seed + 1)))


def _tensors(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_lafc(model, steps: int, h: int, w: int, device: str,
               pan: float = 2.0):
    """Overfit ``model`` (in place) on :func:`lafc_batch` for ``steps``
    Adam steps at lr 2e-4, f32, no clip. Returns (loss curve, seconds)."""
    model.to(device).train()
    step = LAFCTrainStep(model, make_adam(model.parameters()),
                         warmup_step_decay(LR, 10 ** 6, 0.1))
    curve = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        m = step(_tensors(lafc_batch(i, h, w, pan=pan), device))
        if (i + 1) % LOG_EVERY == 0 or i == 0:
            curve.append(round(float(m["loss"]), 4))
            print(f"  lafc step {i + 1}/{steps} loss {curve[-1]}",
                  flush=True)
    _sync(device)
    return curve, time.perf_counter() - t0


def train_fgt(gen, steps: int, frames_dir: str, h: int, w: int,
              device: str, pan: float = 2.0, seed: int = 0):
    """Overfit ``gen`` (in place) on :func:`fgt_batch` windows of the
    clip with a fresh T-PatchGAN (dist_cnum 32, seeded) for ``steps``
    GAN steps at lr 2e-4, f32, no flow oracle. Returns (l1 curve,
    seconds)."""
    disc = discriminator.init_discriminator(
        discriminator.TemporalPatchGAN(3, 32),
        torch.Generator().manual_seed(seed + 2))
    gen.to(device).train()
    disc.to(device)
    sched = warmup_step_decay(LR, 10 ** 6, 0.1)
    step = FGTTrainStep(gen, disc, None, make_adam(gen.parameters()),
                        make_adam(disc.parameters()), sched)
    clip = load_clip(frames_dir, h, w)
    curve = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        m = step(_tensors(fgt_batch(i, clip, h, w, pan=pan), device))
        if (i + 1) % LOG_EVERY == 0 or i == 0:
            curve.append(round(float(m["l1_masked"])
                               + float(m["l1_valid"]), 4))
            print(f"  fgt step {i + 1}/{steps} l1 {curve[-1]}", flush=True)
    _sync(device)
    return curve, time.perf_counter() - t0


def save_dir(model, cfg: dict, path: str) -> str:
    checkpoint.save_model_dir({k: v.detach().cpu() for k, v in
                               model.state_dict().items()}, cfg, path)
    return path


# ---------------- scoring ----------------

def run_pipeline_psnr(frames_dir: str, masks_dir: str, out: str,
                      lafc_dir: str, fgt_dir: str, h: int, w: int,
                      device: str, hole_only: bool = False,
                      extra: Sequence[str] = ()):
    """Object removal through the port's CLI with the two checkpoint
    directories (RAFT random from its seed); returns (PSNR of the PNG
    frames it writes against the source frames, or over the hole pixels
    only with ``hole_only`` (one MSE over every hole pixel of the clip),
    and the CLI's wall seconds)."""
    t0 = time.perf_counter()
    vi.main(["--mode", "object_removal", "--path", frames_dir,
             "--path_mask", masks_dir, "--outroot", out, "--imgH", str(h),
             "--imgW", str(w), "--lafc_ckpts", lafc_dir, "--fgt_ckpts",
             fgt_dir, "--raft_model", os.path.join(out, "absent.pth"),
             "--vis_frame", "--device", device, *extra])
    _sync(device)
    wall = time.perf_counter() - t0
    result = image_io.read_stack(os.path.join(out, "frames"), "unchanged")
    gt = image_io.read_stack(frames_dir, "unchanged")
    if gt.shape[1:3] != (h, w):
        gt = image_io.resize_linear(gt.astype(np.float32), h, w)
    n = min(len(result), len(gt))
    if not hole_only:
        return float(np.mean([metrics.psnr(result[i].astype(np.uint8),
                                           gt[i].astype(np.uint8))
                              for i in range(n)])), wall
    holes = image_io.read_stack(masks_dir, "unchanged")
    if holes.ndim == 4:
        holes = holes[..., 0]
    holes = image_io.resize_nearest(holes, h, w) > 0
    d = (result[:n].astype(np.float64) - gt[:n].astype(np.float64))[
        holes[:n]]
    mse = float((d ** 2).sum()) / max(d.size, 1)
    return float(10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))), wall


def card(device: str = DEFAULT_DEVICE) -> dict:
    """The device the run used: the card's name and power limit as
    ``nvidia-smi`` gives them, or the CPU."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


# ---------------- protocols ----------------

def run_full(root: str, frames: int, lafc_steps: int, fgt_steps: int,
             device: str, h: int = H, w: int = W,
             lafc_cfg: Optional[dict] = None, fgt_cfg: Optional[dict] = None,
             extra: Sequence[str] = ()) -> dict:
    """The full recipe (see the module doc); returns its record."""
    lafc_cfg = dict(lafc_cfg or vi.DEFAULT_LAFC_CONFIG)
    fgt_cfg = dict(fgt_cfg or vi.DEFAULT_FGT_CONFIG, res_h=h, res_w=w)
    frames_dir, masks_dir = make_synthetic_data(root, frames, h, w)
    lafc_model, gen = random_models(lafc_cfg, fgt_cfg)
    lafc0 = save_dir(lafc_model, lafc_cfg, os.path.join(root, "ck_lafc0"))
    fgt0 = save_dir(gen, fgt_cfg, os.path.join(root, "ck_fgt0"))
    print("evaluating with random-init weights...", flush=True)
    psnr0, wall0 = run_pipeline_psnr(frames_dir, masks_dir,
                                     os.path.join(root, "out0"), lafc0,
                                     fgt0, h, w, device, extra=extra)
    print(f"PSNR before training: {psnr0:.3f} dB", flush=True)
    print(f"training LAFC {lafc_steps} steps...", flush=True)
    lafc_curve, lafc_s = train_lafc(lafc_model, lafc_steps, h, w, device)
    print(f"training FGT {fgt_steps} steps...", flush=True)
    fgt_curve, fgt_s = train_fgt(gen, fgt_steps, frames_dir, h, w, device)
    lafc1 = save_dir(lafc_model, lafc_cfg, os.path.join(root, "ck_lafc1"))
    fgt1 = save_dir(gen, fgt_cfg, os.path.join(root, "ck_fgt1"))
    print("evaluating with trained weights...", flush=True)
    psnr1, wall1 = run_pipeline_psnr(frames_dir, masks_dir,
                                     os.path.join(root, "out1"), lafc1,
                                     fgt1, h, w, device, extra=extra)
    print(f"PSNR after training: {psnr1:.3f} dB", flush=True)
    return {
        "protocol": f"synthetic pan clip, {frames} frames {w}x{h}, object "
                    "removal, random-init -> LAFC "
                    f"{lafc_steps} + FGT {fgt_steps} overfit steps (f32)",
        "psnr_before_db": round(psnr0, 3), "psnr_after_db": round(psnr1, 3),
        "improved": bool(psnr1 > psnr0),
        "lafc_loss_curve": lafc_curve, "fgt_l1_curve": fgt_curve,
        "lafc_train_s": lafc_s, "fgt_train_s": fgt_s,
        "pipeline_s": [wall0, wall1], **card(device)}


def run_fgt_only(root: str, frames: int, fgt_steps: int, device: str,
                 h: int = H, w: int = W, lafc_cfg: Optional[dict] = None,
                 fgt_cfg: Optional[dict] = None,
                 extra: Sequence[str] = ()) -> dict:
    """The static-clip protocol (see the module doc); returns its
    record."""
    lafc_cfg = dict(lafc_cfg or vi.DEFAULT_LAFC_CONFIG)
    fgt_cfg = dict(fgt_cfg or vi.DEFAULT_FGT_CONFIG, res_h=h, res_w=w)
    frames_dir, masks_dir = make_static_data(root, frames, h, w)
    lafc_model, gen = random_models(lafc_cfg, fgt_cfg)
    lafc0 = save_dir(lafc_model, lafc_cfg, os.path.join(root, "ck_lafc0"))
    fgt0 = save_dir(gen, fgt_cfg, os.path.join(root, "ck_fgt0"))
    print("fgt-only gate: evaluating with random-init weights...",
          flush=True)
    psnr0, wall0 = run_pipeline_psnr(frames_dir, masks_dir,
                                     os.path.join(root, "out0"), lafc0,
                                     fgt0, h, w, device, hole_only=True,
                                     extra=extra)
    print(f"hole PSNR before FGT training: {psnr0:.3f} dB", flush=True)
    print(f"training FGT {fgt_steps} steps on the static clip...",
          flush=True)
    fgt_curve, fgt_s = train_fgt(gen, fgt_steps, frames_dir, h, w, device,
                                 pan=0.0)
    fgt1 = save_dir(gen, fgt_cfg, os.path.join(root, "ck_fgt1"))
    psnr1, wall1 = run_pipeline_psnr(frames_dir, masks_dir,
                                     os.path.join(root, "out1"), lafc0,
                                     fgt1, h, w, device, hole_only=True,
                                     extra=extra)
    print(f"hole PSNR after FGT training: {psnr1:.3f} dB", flush=True)
    return {
        "protocol": f"STATIC camera + static mask, {frames} frames "
                    f"{w}x{h}: flow chains cannot reach the hole, so the "
                    "hole-region PSNR delta isolates FGT; "
                    f"{fgt_steps} overfit steps (f32), LAFC left random "
                    "both times",
        "hole_psnr_before_db": round(psnr0, 3),
        "hole_psnr_after_db": round(psnr1, 3),
        "improved": bool(psnr1 > psnr0), "fgt_l1_curve": fgt_curve,
        "fgt_train_s": fgt_s, "pipeline_s": [wall0, wall1], **card(device)}


def write_record(path: str, rec: dict, fgt_only: bool) -> None:
    """Merge ``rec`` into the JSON at ``path``: the full recipe's keys at
    the top level, the FGT-only record under ``fgt_only``."""
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    if fgt_only:
        merged["fgt_only"] = rec
    else:
        merged.update(rec)
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lafc_steps", type=int, default=150)
    p.add_argument("--fgt_steps", type=int, default=100)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--fgt_only", action="store_true",
                   help="static camera and hole: the hole PSNR delta "
                        "isolates FGT")
    p.add_argument("--out", default="overfit_gate_torch.json",
                   help="JSON record to merge this run into")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--keep", action="store_true",
                   help="keep the scratch directory (clip, checkpoints, "
                        "outputs)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    root = tempfile.mkdtemp(prefix="fgt_overfit_")
    try:
        if args.fgt_only:
            rec = run_fgt_only(root, args.frames, args.fgt_steps,
                               args.device)
        else:
            rec = run_full(root, args.frames, args.lafc_steps,
                           args.fgt_steps, args.device)
        write_record(args.out, rec, args.fgt_only)
        print(json.dumps(rec), flush=True)
    finally:
        if args.keep:
            print(f"kept {root}")
        else:
            shutil.rmtree(root, ignore_errors=True)
    return 0 if rec["improved"] else 1


if __name__ == "__main__":
    sys.exit(main())
