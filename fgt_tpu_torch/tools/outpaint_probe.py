"""Outpainting (video extrapolation) probe — the port's counterpart of
``tools/outpaint_probe.py``: the pipeline's heaviest published workload,
N synthetic frames extrapolated 2x onto a 2H x 2W canvas.

The JAX tool's protocol (208 frames of 432x240 onto an 864x480 canvas),
its flags and its last line: one JSON object with s/frame, the stage
split (the last line of the CLI's ``timings.jsonl``) and the peak host
RSS. The lines before it give the card, the peak device memory, the OOM
back-offs and the launches of kernels K1 (s1), K2 (s6) and K6 (s5).

    python -m fgt_tpu_torch.tools.outpaint_probe               # 208 frames
    python -m fgt_tpu_torch.tools.outpaint_probe --frames 24   # quicker
    python -m fgt_tpu_torch.tools.outpaint_probe --frames 6 --imgH 64 \\
        --imgW 64 --h_scale 1.25 --w_scale 1.25 --device cpu  # CPU smoke

Every other flag goes to the inference CLI
(``fgt_tpu_torch.pipeline.video_inpainting``), in ``--mode
video_extrapolation``; the run is on the card unless ``--device cpu`` is
given. The frames are written under a temporary directory, removed
afterwards unless ``--keep``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import resource
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fgt_tpu_torch.ops import corr_fused, flash_attention, poisson
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline import video_inpainting as vi
from fgt_tpu_torch.tools.overfit_gate import box_filter9, card


def make_pan(root: str, n: int, h: int, w: int) -> str:
    """``tools/outpaint_probe.make_pan``: 9x9 box-filtered noise panning
    2 px a frame, ``n`` PNG frames of h x w under ``root/frames``.
    Returns that directory."""
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    pan = 2
    base = (rng.rand(h + 8, w + pan * n + 8, 3) * 255).astype(np.float32)
    base = box_filter9(base).astype(np.uint8)
    for i in range(n):
        image_io.write_png(os.path.join(frames_dir, f"{i:05d}.png"),
                           base[4:4 + h, 4 + pan * i:4 + pan * i + w])
    return frames_dir


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=208)
    ap.add_argument("--imgH", type=int, default=240)
    ap.add_argument("--imgW", type=int, default=432)
    ap.add_argument("--h_scale", type=float, default=2.0)
    ap.add_argument("--w_scale", type=float, default=2.0)
    ap.add_argument("--keep", action="store_true")
    return ap


def cli_argv(frames_dir: str, outroot: str, args, passthrough) -> list:
    """The inference CLI's arguments of one probe run."""
    return ["--mode", "video_extrapolation", "--path", frames_dir,
            "--path_mask", frames_dir,   # unused in this mode
            "--outroot", outroot,
            "--imgH", str(args.imgH), "--imgW", str(args.imgW),
            "--H_scale", str(args.h_scale),
            "--W_scale", str(args.w_scale)] + list(passthrough)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args, passthrough = build_parser().parse_known_args(argv)
    root = tempfile.mkdtemp(prefix="fgt_outpaint_")
    try:
        frames_dir = make_pan(root, args.frames, args.imgH, args.imgW)
        outroot = os.path.join(root, "out")
        cli = vi.build_parser().parse_args(
            cli_argv(frames_dir, outroot, args, passthrough))
        on_card = torch.device(cli.device).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        kernels = (corr_fused.lookup_corr_fused, flash_attention.flash_mhsa,
                   poisson.poisson_pcg)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out_path = vi.video_inpainting(cli)
        wall = time.perf_counter() - t0
        assert os.path.exists(out_path)
        with open(os.path.join(outroot, "timings.jsonl")) as f:
            rec = json.loads(f.readlines()[-1])
        peak_gb = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(json.dumps(card(cli.device)), flush=True)
        print(json.dumps({
            "peak_device_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                if on_card else None),
            "backoffs": rec["backoffs"],
            "launches": {k.__name__: k.launches for k in kernels}}),
            flush=True)
        result = {
            "metric": "outpaint_s_per_frame",
            "value": round(wall / args.frames, 3),
            "unit": "s/frame",
            "frames": args.frames,
            "canvas": [int(args.imgH * args.h_scale),
                       int(args.imgW * args.w_scale)],
            "total_s": round(wall, 1),
            "stages_s": {k: round(v, 1) for k, v in rec["stages"].items()},
            "peak_host_rss_gb": round(peak_gb, 1),
        }
        print(json.dumps(result), flush=True)
        return result
    finally:
        if not args.keep:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
