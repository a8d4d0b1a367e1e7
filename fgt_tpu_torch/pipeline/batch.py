"""Batch driver: inpaint many videos with one resident model set — the
port's counterpart of ``fgt_tpu/pipeline/batch.py``.

:class:`~fgt_tpu_torch.pipeline.video_inpainting.Models` is built once
and every video directory under ``--videos_root`` (PNG or JPEG frames;
masks under ``--masks_root``, same names) goes through it. Results land in
``--outroot/<video>/``, with one ``batch_summary.jsonl`` row per video
(ok or the error, wall seconds, output path). A failing video is logged
and the batch goes on.

    python -m fgt_tpu_torch.pipeline.batch --videos_root frames \\
        --masks_root masks --outroot out --imgH 240 --imgW 432
"""

from __future__ import annotations

import json
import logging
import os
import time

from fgt_tpu_torch.pipeline.video_inpainting import (build_models,
                                                     build_parser,
                                                     video_inpainting)

logger = logging.getLogger("fgt_tpu_torch")


def iter_videos(videos_root: str, masks_root: str | None):
    """(name, frames dir, masks dir or None) of every video, by name;
    videos without a mask directory are skipped when masks are given."""
    for name in sorted(os.listdir(videos_root)):
        vdir = os.path.join(videos_root, name)
        if not os.path.isdir(vdir):
            continue
        mdir = os.path.join(masks_root, name) if masks_root else None
        if mdir is not None and not os.path.isdir(mdir):
            logger.warning("skipping %s: no mask dir %s", name, mdir)
            continue
        yield name, vdir, mdir


def run_batch(args, models=None) -> list:
    """Inpaint every video of ``args.videos_root`` with one ``Models``
    (built from ``args`` unless given); returns the summary rows."""
    models = models or build_models(args)
    os.makedirs(args.outroot, exist_ok=True)
    summary_path = os.path.join(args.outroot, "batch_summary.jsonl")
    videos = list(iter_videos(args.videos_root, args.masks_root))
    logger.info("batch: %d videos, mode=%s", len(videos), args.mode)
    results = []
    for i, (name, vdir, mdir) in enumerate(videos):
        vargs = build_parser().parse_args([])
        vargs.__dict__.update(args.__dict__)
        vargs.path, vargs.path_mask = vdir, mdir
        vargs.outroot = os.path.join(args.outroot, name)
        t0 = time.perf_counter()
        try:
            out = video_inpainting(vargs, models=models)
            rec = {"video": name, "ok": True, "out": out}
        except Exception as e:  # the batch goes on past a failing video
            logger.exception("video %s failed", name)
            rec = {"video": name, "ok": False, "error": str(e)}
        rec["wall_s"] = round(time.perf_counter() - t0, 3)
        results.append(rec)
        with open(summary_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        logger.info("[%d/%d] %s: %s (%.2f s)", i + 1, len(videos), name,
                    "ok" if rec["ok"] else "FAILED", rec["wall_s"])
    return results


def main(argv=None) -> list:
    logging.basicConfig(level=logging.INFO)
    p = build_parser()
    p.add_argument("--videos_root", required=True,
                   help="directory of per-video frame subdirectories")
    p.add_argument("--masks_root", default=None,
                   help="directory of per-video mask subdirectories "
                        "(object and watermark removal)")
    results = run_batch(p.parse_args(argv))
    logger.info("batch done: %d/%d ok", sum(r["ok"] for r in results),
                len(results))
    return results


if __name__ == "__main__":
    main()
