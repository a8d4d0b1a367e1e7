"""Random moving-blob hole masks for training — counterpart of
``fgt_tpu/core/masks.py`` (the reference STTN mask generator,
FGT/data/util/STTN_mask.py:96-243).

A random closed cubic-bezier blob is rasterized, placed at a random
position, and either kept static (50%) or moved with a random velocity
and gaussian acceleration; per step the blob may zoom in or out (25%)
or rotate (25%). Returns one ``[H, W]`` uint8 {0, 255} mask per frame.

Draws from ``random`` and ``np.random`` in the JAX package's order, so
the same seeds give the same masks; the cv2 calls are the bit-equal
twins of ``core/raster.py``. The free-form stroke generator
(``get_video_masks_by_moving_random_stroke``) is a dataset-preparation
tool, not on the training path, and is not ported.
"""

from __future__ import annotations

import math
import random

import numpy as np

from fgt_tpu_torch.core import raster
from fgt_tpu_torch.pipeline.image_io import resize_nearest


def _sample_bezier_path(verts: np.ndarray, samples_per_seg: int = 24
                        ) -> np.ndarray:
    """Sample a closed piecewise-cubic bezier path defined by control
    verts ``[p0, c0a, c0b, p1, c1a, c1b, p2, ...]`` (3n + 1 points)."""
    pts = []
    t = np.linspace(0.0, 1.0, samples_per_seg, endpoint=False)[:, None]
    for s in range((len(verts) - 1) // 3):
        p0, p1, p2, p3 = verts[3 * s: 3 * s + 4]
        pts.append(((1 - t) ** 3) * p0 + 3 * ((1 - t) ** 2) * t * p1
                   + 3 * (1 - t) * (t ** 2) * p2 + (t ** 3) * p3)
    return np.concatenate(pts, axis=0)


def _resize_nearest2d(img: np.ndarray, h: int, w: int) -> np.ndarray:
    return resize_nearest(img[None], h, w)[0]


def get_random_shape(edge_num: int = 9, ratio: float = 0.7,
                     width: int = 432, height: int = 240) -> np.ndarray:
    """Random blob as an ``[h, w]`` uint8 {0, 255} array, tightly
    cropped: control points on a perturbed unit circle, rasterized at
    256 x 256 and nearest-resized to (height, width)."""
    points_num = edge_num * 3 + 1
    angles = np.linspace(0, 2 * np.pi, points_num)
    radii = 2 * ratio * np.random.random(points_num) + 1 - ratio
    verts = np.stack((np.cos(angles), np.sin(angles)), axis=1) \
        * radii[:, None]
    verts[-1] = verts[0]
    path = _sample_bezier_path(verts)
    lo, hi = path.min(axis=0), path.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    raster_size = 256
    poly = ((path - lo) / span * (raster_size - 1)).astype(np.int32)
    canvas = raster.fill_poly(np.zeros((raster_size, raster_size),
                                       np.uint8), poly, 255)
    region = _resize_nearest2d(canvas, height, width)
    ys, xs = np.nonzero(region)
    if ys.size == 0:  # degenerate path; fall back to a centered ellipse
        return raster.fill_ellipse(np.zeros((height, width), np.uint8),
                                   (width // 2, height // 2),
                                   (width // 3, height // 3), 255)
    return region[ys.min(): ys.max() + 1, xs.min(): xs.max() + 1]


def get_random_velocity(max_speed: float = 3, dist: str = "uniform",
                        rng=np.random):
    if dist == "uniform":
        speed = rng.uniform(max_speed)
    elif dist == "guassian":  # sic — reference spelling
        speed = np.abs(rng.normal(0, max_speed / 2))
    else:
        raise NotImplementedError(
            f"Distribution type {dist} is not supported.")
    angle = rng.uniform(0, 2 * np.pi)
    return (speed, angle)


def _random_accelerate(velocity, max_acceleration, dist="uniform",
                       rng=np.random):
    speed, angle = velocity
    d_speed, d_angle = max_acceleration
    if dist == "uniform":
        speed += rng.uniform(-d_speed, d_speed)
        angle += rng.uniform(-d_angle, d_angle)
    elif dist == "guassian":
        speed += rng.normal(0, d_speed / 2)
        angle += rng.normal(0, d_angle / 2)
    else:
        raise NotImplementedError(
            f"Distribution type {dist} is not supported.")
    return (speed, angle)


def _move(x, y, h, w, velocity, region_size,
          max_acceleration=(3, 0.5), max_init_speed=3):
    region_h, region_w = region_size
    speed, angle = velocity
    x += int(speed * math.cos(angle))
    y += int(speed * math.sin(angle))
    velocity = _random_accelerate(velocity, max_acceleration,
                                  dist="guassian")
    if x > h - region_h or x < 0 or y > w - region_w or y < 0:
        velocity = get_random_velocity(max_init_speed, dist="guassian")
    return (int(np.clip(x, 0, max(h - region_h, 0))),
            int(np.clip(y, 0, max(w - region_w, 0))), velocity)


def _paste(region: np.ndarray, x: int, y: int, h: int, w: int
           ) -> np.ndarray:
    m = np.zeros((h, w), dtype=np.uint8)
    rh, rw = region.shape
    rh, rw = min(rh, h - x), min(rw, w - y)
    if rh > 0 and rw > 0:
        m[x: x + rh, y: y + rw] = region[:rh, :rw]
    return m


def create_random_shape_with_random_motion(
        video_length: int, zoomin: float = 0.9, zoomout: float = 1.1,
        rotmin: float = 1, rotmax: float = 10,
        imageHeight: int = 240, imageWidth: int = 432) -> list:
    """``video_length`` ``[H, W]`` uint8 masks: static 50% / moving 50%,
    with zoom and rotation augments (reference STTN_mask.py:96-141)."""
    if not (zoomin < 1 and zoomout > 1 and rotmin < rotmax):
        raise ValueError("need zoomin < 1 < zoomout and rotmin < rotmax")
    height = random.randint(imageHeight // 3, imageHeight - 1)
    width = random.randint(imageWidth // 3, imageWidth - 1)
    edge_num = random.randint(6, 8)
    ratio = random.randint(6, 8) / 10
    region = get_random_shape(edge_num=edge_num, ratio=ratio,
                              height=height, width=width)
    region_h, region_w = region.shape
    x = random.randint(0, imageHeight - region_h)
    y = random.randint(0, imageWidth - region_w)
    velocity = get_random_velocity(max_speed=3)
    masks = [_paste(region, x, y, imageHeight, imageWidth)]
    if random.uniform(0, 1) > 0.5:
        return masks * video_length  # static mask for the whole clip

    for _ in range(video_length - 1):
        x, y, velocity = _move(x, y, imageHeight, imageWidth, velocity,
                               region.shape, max_acceleration=(3, 0.5),
                               max_init_speed=3)
        extra = random.uniform(0, 1)
        if extra > 0.75:  # zoom in / out
            coef = random.uniform(zoomin, zoomout)
            nh = max(1, math.ceil(region_h * coef))
            nw = max(1, math.ceil(region_w * coef))
            region = _resize_nearest2d(region, nh, nw)
            region_h, region_w = region.shape
            m = _paste(region, x, y, imageHeight, imageWidth)
        elif extra > 0.5:  # rotation about the image center
            m = _paste(region, x, y, imageHeight, imageWidth)
            angle = random.randint(int(rotmin), int(rotmax))
            rot = raster.rotation_matrix_2d(
                (imageWidth / 2, imageHeight / 2), angle, 1.0)
            m = raster.warp_affine_nearest(m, rot, imageWidth, imageHeight)
        else:
            m = _paste(region, x, y, imageHeight, imageWidth)
        masks.append(m)
    return masks


def rect_mask(height: int, width: int, size: int = 96,
              center: tuple | None = None) -> np.ndarray:
    """Centered square mask of the reference validation protocol
    (FGT/config/valid_config.yaml — rectMask_96)."""
    m = np.zeros((height, width), dtype=np.uint8)
    cy, cx = center if center is not None else (height // 2, width // 2)
    y0, x0 = max(0, cy - size // 2), max(0, cx - size // 2)
    m[y0: y0 + size, x0: x0 + size] = 255
    return m


def get_masked_ratio(mask: np.ndarray) -> float:
    """Hole fraction of a mask."""
    return float((np.asarray(mask) > 0).mean())


def bbox_mask(height: int, width: int, rng=None,
              margin_ratio: float = 0.1,
              size_ratio=(0.3, 0.5)) -> np.ndarray:
    """Random rectangular hole (reference MaskModel bbox masks)."""
    rng = rng or np.random.RandomState()
    bh = int(height * rng.uniform(*size_ratio))
    bw = int(width * rng.uniform(*size_ratio))
    my = int(height * margin_ratio)
    mx = int(width * margin_ratio)
    y = rng.randint(my, max(height - bh - my, my + 1))
    x = rng.randint(mx, max(width - bw - mx, mx + 1))
    m = np.zeros((height, width), np.uint8)
    m[y:y + bh, x:x + bw] = 255
    return m
