"""Offline RAFT flow extraction over a dataset tree — the port's
counterpart of ``fgt_tpu/pipeline/flow_extract.py`` (reference
tool/flow_extract.py:55-192). LAFC's training flows are made this way.

For every video under ``--datapath`` (a directory of ``*.png`` /
``*.jpg`` frames, EXIF orientation ignored as the JAX tool's imageio
reads them, or a ``<video>.npy`` stack [N, H, W, 3]), frames are resized
to
``--height`` x ``--width`` (cv2 ``INTER_LINEAR`` on float frames, as the
JAX tool), and forward and backward flows between consecutive frames are
written as ``<outroot>/<video>/forward_flo/NNNNN.flo`` and
``backward_flo/NNNNN.flo``. RAFT runs in f32 through ``RAFT.forward`` on
the all-pairs pyramid path (kernel K3 on the card), ``--chunk`` pairs per
call.

    python -m fgt_tpu_torch.pipeline.flow_extract --datapath frames \\
        --outroot flows [--raft_model raft.pth | raft.msgpack] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.convert.weights import load_state, load_weights
from fgt_tpu_torch.core import flow_io
from fgt_tpu_torch.models import raft as raft_mod
from fgt_tpu_torch.pipeline import image_io

logger = logging.getLogger("fgt_tpu_torch")


def load_raft(path: str, device: str = DEFAULT_DEVICE,
              seed: int = 0) -> raft_mod.RAFT:
    """f32 RAFT from a reference state dict or the JAX package's
    ``raft.msgpack``, or seeded random weights."""
    model = raft_mod.init_raft(raft_mod.RAFT(),
                               torch.Generator().manual_seed(seed))
    if os.path.exists(path):
        load_state(model, load_weights(path, "raft"))
    else:
        logger.warning("RAFT weights not found at %s; random init (seed %d)",
                       path, seed)
    return model.to(device).eval().requires_grad_(False)


def extract_video(raft: raft_mod.RAFT, frames: np.ndarray, out_dir: str,
                  iters: int = 20, chunk: int = 4) -> None:
    """frames: [N, H, W, 3] float in [0, 255]. Writes forward_flo/ and
    backward_flo/ .flo files, N-1 each, at the frames' resolution."""
    n = frames.shape[0]
    dev = next(raft.parameters()).device
    video = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(dev)
    for sub, src, dst in (("forward_flo", video[:-1], video[1:]),
                          ("backward_flo", video[1:], video[:-1])):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        for lo in range(0, n - 1, chunk):
            with torch.inference_mode():
                _, up = raft(src[lo:lo + chunk], dst[lo:lo + chunk], iters)
            for k, flow in enumerate(up.float().cpu().numpy()):
                flow_io.write_flow(flow, os.path.join(out_dir, sub,
                                                      f"{lo + k:05d}.flo"))


def list_videos(datapath: str) -> list:
    """(name, path) of every frame directory and ``.npy`` stack, by
    name."""
    out = []
    for name in sorted(os.listdir(datapath)):
        path = os.path.join(datapath, name)
        if os.path.isdir(path):
            out.append((name, path))
        elif name.endswith(".npy"):
            out.append((name[:-4], path))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="RAFT flows of every video under --datapath. Frames are "
                    "directories of *.png / *.jpg files (Huffman-coded 8-bit "
                    "JPEG, baseline or progressive) or "
                    ".npy stacks.")
    p.add_argument("--datapath", required=True,
                   help="root of per-video frame directories / .npy stacks")
    p.add_argument("--outroot", required=True)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=432)
    p.add_argument("--raft_model", default="checkpoints/raft/raft.pth",
                   help="reference RAFT state dict or the JAX package's "
                        "raft.msgpack (random init if absent)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--chunk", type=int, default=4,
                   help="frame pairs per RAFT call")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init without weights")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    raft = load_raft(args.raft_model, args.device, args.seed)
    total, t0 = 0, time.perf_counter()
    for name, path in list_videos(args.datapath):
        frames = image_io.read_stack(path, "unchanged")
        if frames.ndim == 3:
            frames = np.repeat(frames[..., None], 3, axis=-1)
        if frames.shape[0] < 2:
            continue
        frames = image_io.resize_linear(frames[..., :3], args.height,
                                        args.width)
        tv = time.perf_counter()
        extract_video(raft, frames, os.path.join(args.outroot, name),
                      args.iters, args.chunk)
        if args.device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - tv
        total += len(frames)
        logger.info("%s: %d frames, %.3f s/frame", name, len(frames),
                    dt / len(frames))
    dt = time.perf_counter() - t0
    logger.info("done: %d frames in %.1f s (%.3f s/frame)", total, dt,
                dt / max(total, 1))
    return total


if __name__ == "__main__":
    main()
