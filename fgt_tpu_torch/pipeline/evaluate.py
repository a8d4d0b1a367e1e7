"""Dataset evaluation: PSNR / SSIM / L1 / L2 / VFID over a DAVIS-style tree
— the port's counterpart of ``tools/evaluate.py``.

    python -m fgt_tpu_torch.pipeline.evaluate --frames F --masks M \\
        [--outroot out_eval] [--num_videos N] [--imgH 240 --imgW 432] \\
        [--lafc_ckpts D --fgt_ckpts D --raft_model P] \\
        [--vfid_ckpt rgb_imagenet.pt | i3d.msgpack] [--raft_iters 20] \\
        [--device cuda]

Layout: ``F/<video>/`` and ``M/<video>/`` PNG directories (or
``<video>.npy`` stacks under both roots); holes are the masks' nonzero
pixels. Every video goes through the object-removal pipeline with one
resident model set (:func:`~fgt_tpu_torch.pipeline.video_inpainting.build_models`),
and its lossless ``result.npy`` is scored on the whole frame against the
source frames resized as the JAX tool resizes them (``cv2.resize`` on
uint8: :func:`~fgt_tpu_torch.pipeline.image_io.resize_linear_u8`).
``--vfid_ckpt`` is a pytorch-i3d ``InceptionI3d`` state dict (``.pt`` /
``.pth``) or the JAX package's converted I3D (``i3d.msgpack``, written
by ``tools/convert_weights.py i3d``); without it VFID is skipped, as
random I3D features say nothing. I3D runs in float32 without TF32
(``core.vfid.F32_PRECISION``). Writes ``<outroot>/eval.json`` (summary
and per-video numbers) and prints the summary as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np

from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.core import metrics as M
from fgt_tpu_torch.core.vfid import F32_PRECISION, VFIDScorer
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline import video_inpainting as vi
from fgt_tpu_torch.convert.weights import load_weights

logger = logging.getLogger("fgt_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", required=True)
    ap.add_argument("--masks", required=True)
    ap.add_argument("--outroot", default="out_eval")
    ap.add_argument("--num_videos", type=int, default=-1)
    ap.add_argument("--imgH", type=int, default=240)
    ap.add_argument("--imgW", type=int, default=432)
    ap.add_argument("--lafc_ckpts", default="checkpoints/lafc")
    ap.add_argument("--fgt_ckpts", default="checkpoints/fgt")
    ap.add_argument("--raft_model", default="checkpoints/raft/raft.pth")
    ap.add_argument("--vfid_ckpt", default="",
                    help="pytorch-i3d state dict (.pt/.pth) or the JAX "
                         "package's i3d.msgpack; VFID is skipped without "
                         "it")
    ap.add_argument("--raft_iters", type=int, default=20)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap


def ground_truth(path: str, n: int, img_h: int, img_w: int) -> np.ndarray:
    """The first ``n`` source frames (PNG or JPEG, EXIF orientation
    ignored as the JAX tool's imageio reads them), RGB, resized to
    img_h x img_w as ``cv2.resize`` resizes uint8."""
    frames = image_io.read_stack(path, "unchanged")[:n]
    if frames.ndim == 3:
        frames = np.repeat(frames[..., None], 3, axis=-1)
    return np.stack([image_io.resize_linear_u8(f[..., :3], img_h, img_w)
                     for f in frames])


def score_video(result: np.ndarray, gt: np.ndarray) -> dict:
    """Mean per-frame PSNR and SSIM, and L1 / L2 over the whole clip
    (tools/evaluate.py's numbers)."""
    diff = result.astype(np.float64) - gt.astype(np.float64)
    return {"psnr": float(np.mean([M.psnr(r, g) for r, g in zip(result, gt)])),
            "ssim": float(np.mean([M.ssim(r, g) for r, g in zip(result, gt)])),
            "l1": float(np.abs(diff).mean()), "l2": float((diff ** 2).mean())}


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    videos = sorted(os.listdir(args.frames))
    if args.num_videos > 0:
        videos = videos[:args.num_videos]
    pipe_args = vi.build_parser().parse_args([
        "--mode", "object_removal", "--imgH", str(args.imgH),
        "--imgW", str(args.imgW), "--lafc_ckpts", args.lafc_ckpts,
        "--fgt_ckpts", args.fgt_ckpts, "--raft_model", args.raft_model,
        "--raft_iters", str(args.raft_iters), "--device", args.device])
    models = vi.build_models(pipe_args)
    scorer = None
    if args.vfid_ckpt:
        scorer = VFIDScorer(load_weights(args.vfid_ckpt, "i3d"),
                            device=args.device)
        logger.info("VFID: I3D from %s, %s", args.vfid_ckpt, F32_PRECISION)

    per_video = {}
    total_frames = 0
    t_start = time.perf_counter()
    for video in videos:
        pipe_args.path = os.path.join(args.frames, video)
        pipe_args.path_mask = os.path.join(args.masks, video)
        pipe_args.outroot = os.path.join(args.outroot,
                                         video.removesuffix(".npy"))
        result = np.load(vi.video_inpainting(pipe_args, models=models))
        gt = ground_truth(pipe_args.path, len(result), args.imgH, args.imgW)
        total_frames += len(gt)
        per_video[video] = score_video(result, gt)
        logger.info("%s: psnr=%.2f ssim=%.4f", video,
                    per_video[video]["psnr"], per_video[video]["ssim"])
        if scorer is not None:
            scorer.update(gt, result)

    wall = time.perf_counter() - t_start
    summary = {"num_videos": len(per_video), "frames": total_frames,
               "fps": total_frames / wall}
    for key in ("psnr", "ssim", "l1", "l2"):
        summary[key] = float(np.mean([v[key] for v in per_video.values()]))
    summary["per_video"] = per_video
    if scorer is not None:
        summary["vfid"] = scorer.score()
    os.makedirs(args.outroot, exist_ok=True)
    with open(os.path.join(args.outroot, "eval.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items() if k != "per_video"}),
          flush=True)
    return summary


if __name__ == "__main__":
    main()
