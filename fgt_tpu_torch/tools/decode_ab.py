"""The host decode path of two checkouts, interleaved on one host.

    python -m fgt_tpu_torch.tools.decode_ab --other DIR [--out FILE]

``DIR`` is the root of another checkout of this repository (``git
archive`` of the parent commit, say). Data is made once, from a seed,
with this checkout's JPEG encoder (baseline 4:2:0, q90, as DAVIS and
YouTube-VOS ship their frames). Each checkout then runs in processes of
its own (``PYTHONPATH`` its root), in blocks of other, this, this, other,
so that a drift of the host's speed falls on both alike:

* 4 blocks of short runs: ``decode_ms``, one 854x480 frame through
  ``core.jpeg.decode_jpeg`` (3 rounds of 30 decodes a run); ``load_s``,
  the inference CLI's s0 load, ``load_frames`` of a 24-frame 854x480
  JPEG clip to 240x432 (the second of two loads a run);
* 1 block of ``items_per_s``: the training loader alone over
  ``FGTVideoDataset`` (``configs/fgt_train.yaml``'s sample, batch 2 and
  4 workers, and 0 workers) on a tree of 4 videos x 16 JPEG frames
  480x864 with .flo 240x432 flows, as ``chip_smoke.py``'s training phase
  writes it.

Host code only: no card is used. Prints one JSON line a run, then the
per-checkout medians (decode, load) and means (items/s) as the last
line's JSON object, which ``--out`` also receives with every run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the measurement, run in the checkout under test (its API as of both)
CHILD = r"""
import json, os, random, sys, time
import numpy as np
import fgt_tpu_torch

data_root, part = sys.argv[1:3]
out = {"package": os.path.dirname(fgt_tpu_torch.__file__)}
if part == "decode":
    from fgt_tpu_torch.core import jpeg
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    with open(os.path.join(data_root, "frame.jpg"), "rb") as f:
        frame = f.read()
    jpeg.decode_jpeg(frame)
    out["decode_ms"] = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(30):
            jpeg.decode_jpeg(frame)
        out["decode_ms"].append(1e3 * (time.perf_counter() - t0) / 30)
    for _ in range(2):
        t0 = time.perf_counter()
        vi.load_frames(os.path.join(data_root, "clip"), 240, 432)
        out["load_s"] = time.perf_counter() - t0
else:
    from fgt_tpu_torch.data import DataLoader
    from fgt_tpu_torch.data.datasets import FGTVideoDataset

    opt = {"input_resolution": [240, 432], "num_frames": 5,
           "flow_direction": "for", "sample": "random"}
    info = {"frame_path": os.path.join(data_root, "tree", "frames"),
            "flow_path": os.path.join(data_root, "tree", "flows"),
            "name2len": None}
    dataset = FGTVideoDataset(opt, info)
    out["items_per_s"] = {}
    for workers, items in ((4, 48), (0, 16)):
        random.seed(0)
        np.random.seed(0)
        order = [i % len(dataset) for i in range(items + 2)]
        with DataLoader(dataset, 2, sampler=order, num_workers=workers,
                        drop_last=True) as loader:
            it = iter(loader)
            next(it)
            t0 = time.perf_counter()
            n = sum(len(b["frames"]) for b in it)
            out["items_per_s"][workers] = n / (time.perf_counter() - t0)
print(json.dumps(out))
"""

DECODE_BLOCKS = 4


def smooth_noise(h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """[h, w, 3] uint8 noise under a 9x9 box blur (cumulative sums)."""
    x = rng.rand(h + 8, w + 8, 3) * 255
    c = np.pad(x.cumsum(0).cumsum(1), ((1, 0), (1, 0), (0, 0)))
    box = c[9:, 9:] - c[:-9, 9:] - c[9:, :-9] + c[:-9, :-9]
    return (box / 81).astype(np.uint8)


def write_data(root: str, seed: int = 3) -> None:
    """frame.jpg, clip/NNNNN.jpg (24 frames panning 4 px) and tree/."""
    from fgt_tpu_torch.core.flow_io import write_flow
    from fgt_tpu_torch.core.jpeg_encode import encode_jpeg

    def put(path: str, img: np.ndarray) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(encode_jpeg(img, 90, "420"))

    rng = np.random.RandomState(seed)
    base = smooth_noise(480, 854 + 4 * 24, rng)
    put(os.path.join(root, "frame.jpg"), base[:, :854])
    for i in range(24):
        put(os.path.join(root, "clip", f"{i:05d}.jpg"),
            base[:, 4 * i:4 * i + 854])
    for v in range(4):
        big = smooth_noise(480, 864 + 2 * 16, rng)
        flows = os.path.join(root, "tree", "flows", f"video_{v:02d}")
        for i in range(16):
            put(os.path.join(root, "tree", "frames", f"video_{v:02d}",
                             f"{i:05d}.jpg"), big[:, 2 * i:2 * i + 864])
        for d in ("forward_flo", "backward_flo"):
            os.makedirs(os.path.join(flows, d))
            for i in range(15):
                write_flow(4 * rng.rand(240, 432, 2).astype(np.float32) - 2,
                           os.path.join(flows, d, f"{i:05d}.flo"))


def run(checkout: str, data_root: str, part: str) -> dict:
    env = dict(os.environ, PYTHONPATH=checkout)
    proc = subprocess.run([sys.executable, "-c", CHILD, data_root, part],
                          cwd=checkout, env=env, capture_output=True,
                          text=True, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if not out["package"].startswith(os.path.abspath(checkout)):
        raise RuntimeError(f"{checkout}: imported {out['package']}")
    return dict(out, checkout=checkout, part=part)


def summary(runs: list, checkout: str) -> dict:
    mine = [r for r in runs if r["checkout"] == checkout]
    decode = [ms for r in mine for ms in r.get("decode_ms", [])]
    loads = [r["load_s"] for r in mine if "load_s" in r]
    rates = [r["items_per_s"] for r in mine if "items_per_s" in r]
    return {"decode_ms": float(np.median(decode)),
            "decode_ms_min": min(decode),
            "load_s": float(np.median(loads)), "load_s_min": min(loads),
            "items_per_s": {w: float(np.mean([r[w] for r in rates]))
                            for w in rates[0]}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with this one")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    other = os.path.abspath(args.other)
    runs = []
    with tempfile.TemporaryDirectory() as data_root:
        write_data(data_root)
        for part in ["decode"] * DECODE_BLOCKS + ["loader"]:
            for checkout in (other, ROOT, ROOT, other):
                runs.append(run(checkout, data_root, part))
                print(json.dumps(runs[-1]), flush=True)
    result = {"other": summary(runs, other), "this": summary(runs, ROOT)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(result, runs=runs), f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
