"""Traffic: a mix is a JSON file ``portbench/traffic/<name>.json`` of
parameters, and its ``kind`` names the generator that reads it,
``portbench/generators/<kind>.py``, whose ``make(mix, seed, device)``
returns the cell's traffic:

* ``removal_clips``: a pool of object-removal clips of smoothed noise
  panning ``pan_px`` a frame, each with a hole made by
  ``portbench/holes/<hole.kind>.py`` (``square``: a square moving with
  the pan; ``strokes``: the FVI moving-stroke masks, :func:`stroke_masks`);
* ``train_batches``: GAN training batches made on the card.

This module holds what the generators share. The background is
``bench.py``'s protocol (its numpy form ``chip_smoke.synthetic_video``,
copied here).
"""

from __future__ import annotations

import math

import numpy as np
import scipy.ndimage

from portbench import common


def load_mix(name: str) -> dict:
    return common.load_json("traffic", f"{name}.json")


def make(mix: dict, seed: int, device=None):
    """The traffic of ``mix`` for the run's ``seed``, from the generator
    its ``kind`` names."""
    return common.load_module("generators", mix["kind"]).make(mix, seed,
                                                              device)


def panning_background(rng, n: int, h: int, w: int, pan: int) -> np.ndarray:
    """[n, h, w, 3] u8: a 9x9 box-smoothed noise image, each frame
    shifted ``pan`` px right of the one before."""
    base = (rng.rand(h + 8, w + pan * n + 8, 3) * 255).astype(np.uint8)
    base = scipy.ndimage.uniform_filter(base.astype(np.float32),
                                        size=(9, 9, 1), mode="mirror")
    base = base.astype(np.uint8)
    return np.stack([base[4:4 + h, 4 + pan * i:4 + pan * i + w]
                     for i in range(n)])


def square_masks(n, h, w, size, y0, x0, pan) -> np.ndarray:
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        masks[i, y0:y0 + size, x0 + pan * i:x0 + pan * i + size] = 1
    return masks


def _segment(img: np.ndarray, p0, p1, width: int) -> None:
    """Set the pixels within (width + 1) // 2 of the segment p0-p1: a
    band of ``width`` with round caps, as wide as cv2's thick line to
    within a few tenths of a percent of the frame's pixels."""
    h, w = img.shape
    r = (width + 1) // 2
    x0, y0 = p0
    x1, y1 = p1
    lo_x, hi_x = max(0, int(min(x0, x1) - r)), min(w, int(max(x0, x1) + r) + 1)
    lo_y, hi_y = max(0, int(min(y0, y1) - r)), min(h, int(max(y0, y1) + r) + 1)
    if lo_x >= hi_x or lo_y >= hi_y:
        return
    ys, xs = np.mgrid[lo_y:hi_y, lo_x:hi_x].astype(np.float64)
    dx, dy = x1 - x0, y1 - y0
    ll = dx * dx + dy * dy
    t = np.zeros_like(xs) if ll == 0 else np.clip(
        ((xs - x0) * dx + (ys - y0) * dy) / ll, 0, 1)
    d2 = (xs - x0 - t * dx) ** 2 + (ys - y0 - t * dy) ** 2
    img[lo_y:hi_y, lo_x:hi_x][d2 <= r * r] = 1


def stroke_masks(n: int, h: int, w: int, seed: int, n_stroke: int = 5,
                 n_vertex=(10, 30), max_head_speed: float = 15,
                 max_head_acc=(15, 0.5), brush=(5, 20),
                 move_ratio: float = 0.5, max_point_move: int = 10,
                 max_line_acc: float = 5, max_init_speed: float = 5):
    """[n, h, w] u8 {0, 1}: ``n_stroke`` brush strokes, each a polyline
    drifting with its own velocity from frame to frame while its
    vertices jitter. A copy of ``core/masks.
    get_video_masks_by_moving_random_stroke`` of ``fgt_tpu_torch``
    (commit ac5eac9) with its random draws in the same order; its lines
    are drawn here as round-capped bands, not cv2's polygons."""
    rng = np.random.RandomState(seed)
    strokes = []
    for _ in range(n_stroke):
        k = rng.randint(n_vertex[0], n_vertex[1] + 1)
        x, y = rng.randint(0, w), rng.randint(0, h)
        speed = rng.uniform(0, max_head_speed)
        angle = rng.uniform(0, 2 * math.pi)
        pts = [(x, y)]
        for _ in range(k - 1):
            speed = np.clip(speed + rng.uniform(-max_head_acc[0],
                                                max_head_acc[0]),
                            0, max_head_speed)
            angle += rng.uniform(-max_head_acc[1], max_head_acc[1])
            x = int(np.clip(x + speed * math.cos(angle), 0, w - 1))
            y = int(np.clip(y + speed * math.sin(angle), 0, h - 1))
            pts.append((x, y))
        width = rng.randint(brush[0], brush[1] + 1)
        vel = (rng.uniform(max_init_speed), rng.uniform(0, 2 * np.pi))
        strokes.append({"pts": pts, "width": width, "vel": vel})
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        for s in strokes:
            for a, b in zip(s["pts"][:-1], s["pts"][1:]):
                _segment(masks[i], a, b, s["width"])
        for s in strokes:
            speed, angle = s["vel"]
            dx, dy = int(speed * math.cos(angle)), int(speed * math.sin(angle))
            new_pts = []
            for (x, y) in s["pts"]:
                if rng.uniform(0, 1) < move_ratio:
                    x += rng.randint(-max_point_move, max_point_move + 1)
                    y += rng.randint(-max_point_move, max_point_move + 1)
                new_pts.append((int(np.clip(x + dx, 0, w - 1)),
                                int(np.clip(y + dy, 0, h - 1))))
            s["pts"] = new_pts
            s["vel"] = (speed + rng.uniform(-max_line_acc, max_line_acc),
                        angle + rng.uniform(-0.5, 0.5))
    return masks


def stroke_kw(hole: dict) -> dict:
    """The :func:`stroke_masks` parameters of a strokes hole."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in hole.items() if k not in ("kind", "mask_seeds")}
