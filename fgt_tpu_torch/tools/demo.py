"""Quick-start demo — the port's counterpart of ``tools/demo.py``.

Runs object removal end to end on a frames + masks directory or, with no
``--path``, on a generated synthetic scene (12 frames at 240x432: 9x9
box-filtered noise panning 2 px a frame, a green block moving across it
and its mask dilated by 4 px, as ``tools/demo.py:synth_scene`` makes
them), and prints the ``result.mp4`` path. Success, as in the reference
README's quick start: a playable ``result.mp4``.

    python -m fgt_tpu_torch.tools.demo                  # synthetic scene
    python -m fgt_tpu_torch.tools.demo --path frames/ --path_mask masks/ \\
        --lafc_ckpts ckpts/lafc --fgt_ckpts ckpts/fgt \\
        --raft_model ckpts/raft-things.pth

Checkpoints: reference ``.pth`` / ``.pth.tar`` state dicts and the JAX
package's ``.msgpack`` directories load directly; without weights the
models run from seeded random weights and every stage still runs. The
synthetic scene is written under ``<outroot>/scene``. It runs on the card
unless ``--device cpu`` is given; any other flag of the inference CLI
(``fgt_tpu_torch.pipeline.video_inpainting``) is passed on to it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline import video_inpainting as vi
from fgt_tpu_torch.tools.overfit_gate import box_filter9


def scene(n: int = 12, h: int = 240, w: int = 432):
    """(frames [n, h, w, 3] uint8, masks [n, h, w] uint8 in {0, 255}) of
    ``tools/demo.py:synth_scene``."""
    rng = np.random.RandomState(0)
    base = (rng.rand(h + 8, w + 2 * n + 8, 3) * 255).astype(np.float32)
    base = box_filter9(base).astype(np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        frames[i] = base[4:4 + h, 4 + 2 * i:4 + 2 * i + w]
        x = 160 + 2 * i
        frames[i, 90:146, x:x + 56] = (40, 200, 60)   # the object to remove
        masks[i, 86:150, x - 4:x + 60] = 255
    return frames, masks


def synth_scene(root: str, n: int = 12, h: int = 240, w: int = 432):
    """The scene as PNG directories ``root/frames`` and ``root/masks``;
    returns their paths."""
    frames, masks = scene(n, h, w)
    dirs = os.path.join(root, "frames"), os.path.join(root, "masks")
    for d, stack in zip(dirs, (frames, masks)):
        os.makedirs(d, exist_ok=True)
        for i, img in enumerate(stack):
            image_io.write_png(os.path.join(d, f"{i:05d}.png"), img)
    return dirs


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="object removal on a frames + masks directory, or on a "
                    "synthetic scene; other flags go to the inference CLI")
    ap.add_argument("--path", default=None, help="frames dir (omit for a "
                    "generated synthetic demo scene)")
    ap.add_argument("--path_mask", default=None)
    ap.add_argument("--outroot", default="demo_out")
    ap.add_argument("--imgH", type=int, default=240)
    ap.add_argument("--imgW", type=int, default=432)
    ap.add_argument("--lafc_ckpts", default="checkpoints/lafc")
    ap.add_argument("--fgt_ckpts", default="checkpoints/fgt")
    ap.add_argument("--raft_model", default="checkpoints/raft-things.pth")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args, extra = ap.parse_known_args(argv)

    if args.path is None:
        root = os.path.join(args.outroot, "scene")
        print(f"no --path given: generating a synthetic demo scene in {root}")
        args.path, args.path_mask = synth_scene(root)

    vi.main([
        "--mode", "object_removal", "--path", args.path,
        "--path_mask", args.path_mask, "--outroot", args.outroot,
        "--imgH", str(args.imgH), "--imgW", str(args.imgW),
        "--lafc_ckpts", args.lafc_ckpts, "--fgt_ckpts", args.fgt_ckpts,
        "--raft_model", args.raft_model, "--device", args.device, *extra])
    out = os.path.join(args.outroot, "result.mp4")
    print(f"\nDemo complete: {out}")
    print("(Reference .pth/.tar and JAX .msgpack checkpoints load directly. "
          "Without weights the models run from seeded random weights; the "
          "pipeline still runs every stage.)")
    return out


if __name__ == "__main__":
    main()
