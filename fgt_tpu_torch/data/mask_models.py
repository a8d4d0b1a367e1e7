"""Mask-model zoo of dataset preparation — counterpart of
``fgt_tpu/data/mask_models.py`` (the reference's ``MaskModel.py:4-122``
and its bbox / free-form helpers, ``utils.py:5-158``).

Each model takes (videoLength, dataInfo) and returns ``[T, H, W, 1]``
float32 masks with 255 = hole. All randomness flows through one seeded
``np.random.RandomState`` in the JAX package's order, so a seed and a
``dataInfo`` give the JAX package's masks bit for bit; the cv2 drawing
calls are ``core/raster.py``'s twins.
"""

from __future__ import annotations

import numpy as np

from fgt_tpu_torch.core import raster
from fgt_tpu_torch.core.masks import get_video_masks_by_moving_random_stroke


def _rng(seed=None):
    return np.random.RandomState(seed)


# ---------------- bbox helpers (reference utils.py:5-90) ----------------

def random_bbox(img_height, img_width, vertical_margin, horizontal_margin,
                mask_height, mask_width, rng=None):
    """(top, left, h, w) with h/w sampled in [half, full] of the mask size."""
    rng = rng or _rng()
    maxt = img_height - vertical_margin - mask_height
    maxl = img_width - horizontal_margin - mask_width
    t = rng.randint(vertical_margin, maxt + 1)
    left = rng.randint(horizontal_margin, maxl + 1)
    h = rng.randint(mask_height // 2, mask_height + 1)
    w = rng.randint(mask_width // 2, mask_width + 1)
    return (t, left, h, w)


def bbox2mask(img_height, img_width, max_delta_height, max_delta_width,
              bbox, rng=None):
    """[H, W, 1] float32 mask with a (possibly jittered-shrunk) 255 box."""
    rng = rng or _rng()
    mask = np.zeros((img_height, img_width, 1), np.float32)
    dh = rng.randint(max_delta_height // 2 + 1)
    dw = rng.randint(max_delta_width // 2 + 1)
    t, left, h, w = bbox
    mask[t + dh: t + h - dh, left + dw: left + w - dw, :] = 255.0
    return mask


def mid_bbox_mask(img_height, img_width, mask_height, mask_width):
    bbox = (img_height * 3 // 8, img_width * 3 // 8,
            mask_height, mask_width)
    mask = np.zeros((img_height, img_width, 1), np.float32)
    mask[bbox[0]: bbox[0] + bbox[2], bbox[1]: bbox[1] + bbox[3], :] = 255.0
    return mask


def matrix2bbox(img_height, img_width, mask_height, mask_width,
                row, column):
    """Grid-cell bboxes: tile the image row x column and return one bbox
    per cell (reference utils.py:55-78)."""
    boxes = []
    cell_h = img_height // row
    cell_w = img_width // column
    for r in range(row):
        for c in range(column):
            t = r * cell_h + max((cell_h - mask_height) // 2, 0)
            left = c * cell_w + max((cell_w - mask_width) // 2, 0)
            boxes.append((t, left, min(mask_height, cell_h),
                          min(mask_width, cell_w)))
    return boxes


def free_form_mask(img_height, img_width, max_vertex=10, max_length=40,
                   max_brush_width=20, max_angle=2 * np.pi, rng=None):
    """Random brush-stroke mask (reference utils.py:116-158): chained
    lines with alternating angle direction, circle caps, random flips.
    Line ends are clipped to [0, W] and [0, H] inclusive, so they may
    lie one past the border."""
    rng = rng or _rng()
    mask = np.zeros((img_height, img_width), np.float32)
    n_vertex = rng.randint(1, max_vertex + 1)
    x = rng.randint(10, img_width)
    y = rng.randint(10, img_height)
    width = rng.randint(10, max(max_brush_width, 11))
    for i in range(n_vertex):
        angle = rng.uniform(0, max_angle)
        if i % 2 == 0:
            angle = 2 * np.pi - angle
        length = rng.randint(10, max(max_length, 11))
        ex = int(np.clip(x + length * np.cos(angle), 0, img_width))
        ey = int(np.clip(y + length * np.sin(angle), 0, img_height))
        raster.thick_line(mask, (x, y), (ex, ey), 255, width)
        raster.circle_filled(mask, (ex, ey), width // 2, 255)
        x, y = ex, ey
    if rng.rand() < 0.5:
        mask = np.fliplr(mask)
    if rng.rand() < 0.5:
        mask = np.flipud(mask)
    return np.ascontiguousarray(mask)[:, :, None]


# ---------------- mask models (reference MaskModel.py) ----------------

class RandomMask:
    """Random bbox; 50% static across the video, 50% random-walking up to
    3 px/frame, clamped to the margins (reference MaskModel.py:4-46)."""

    def __init__(self, videoLength, dataInfo, seed=None):
        self.videoLength = videoLength
        self.h = dataInfo["image"]["image_height"]
        self.w = dataInfo["image"]["image_width"]
        self.mh = dataInfo["mask"]["mask_height"]
        self.mw = dataInfo["mask"]["mask_width"]
        m = dataInfo["mask"]
        self.max_dh = m.get("max_delta_height", 0)
        self.max_dw = m.get("max_delta_width", 0)
        self.vm = m.get("vertical_margin", 0)
        self.hm = m.get("horizontal_margin", 0)
        self.rng = _rng(seed)

    def __call__(self):
        bbox = random_bbox(self.h, self.w, self.vm, self.hm, self.mh,
                           self.mw, rng=self.rng)
        masks = []
        if self.rng.uniform(0, 1) > 0.5:  # static
            mask = bbox2mask(self.h, self.w, 0, 0, bbox, rng=self.rng)
            masks = [mask] * self.videoLength
        else:  # moving
            bbox = list(bbox)
            for _ in range(self.videoLength):
                dh = self.rng.randint(-3, 4)
                dw = self.rng.randint(-3, 4)
                bbox[0] = min(max(self.vm, bbox[0] + dh),
                              self.h - self.vm - bbox[2])
                bbox[1] = min(max(self.hm, bbox[1] + dw),
                              self.w - self.hm - bbox[3])
                masks.append(bbox2mask(self.h, self.w, 0, 0, tuple(bbox),
                                       rng=self.rng))
        return np.stack(masks, axis=0)


class MidRandomMask:
    """Centered-ish static bbox (reference MaskModel.py:48-64)."""

    def __init__(self, videoLength, dataInfo, seed=None):
        self.videoLength = videoLength
        self.h = dataInfo["image"]["image_height"]
        self.w = dataInfo["image"]["image_width"]
        self.mh = dataInfo["mask"]["mask_height"]
        self.mw = dataInfo["mask"]["mask_width"]

    def __call__(self):
        mask = mid_bbox_mask(self.h, self.w, self.mh, self.mw)
        return np.stack([mask] * self.videoLength, axis=0)


class MatrixMask:
    """Grid of bboxes, static across the video
    (reference MaskModel.py:66-88)."""

    def __init__(self, videoLength, dataInfo, seed=None):
        self.videoLength = videoLength
        self.h = dataInfo["image"]["image_height"]
        self.w = dataInfo["image"]["image_width"]
        self.mh = dataInfo["mask"]["mask_height"]
        self.mw = dataInfo["mask"]["mask_width"]
        self.row = dataInfo["mask"].get("row", 2)
        self.column = dataInfo["mask"].get("column", 2)

    def __call__(self):
        mask = np.zeros((self.h, self.w, 1), np.float32)
        for bbox in matrix2bbox(self.h, self.w, self.mh, self.mw,
                                self.row, self.column):
            t, left, h, w = bbox
            mask[t:t + h, left:left + w] = 255.0
        return np.stack([mask] * self.videoLength, axis=0)


class FreeFormMask:
    """Per-frame free-form brush strokes (reference MaskModel.py:90-106)."""

    def __init__(self, videoLength, dataInfo, seed=None):
        self.videoLength = videoLength
        self.h = dataInfo["image"]["image_height"]
        self.w = dataInfo["image"]["image_width"]
        m = dataInfo["mask"]
        self.max_vertex = m.get("max_vertex", 10)
        self.max_length = m.get("max_length", 40)
        self.max_brush_width = m.get("max_brush_width", 20)
        self.max_angle = m.get("max_angle", 2 * np.pi)
        self.rng = _rng(seed)

    def __call__(self):
        return np.stack([
            free_form_mask(self.h, self.w, self.max_vertex, self.max_length,
                           self.max_brush_width, self.max_angle,
                           rng=self.rng)
            for _ in range(self.videoLength)], axis=0)


class StationaryMask:
    """One moving-stroke mask frozen across the video
    (reference MaskModel.py:108-122 uses the FVI stroke generator)."""

    def __init__(self, videoLength, dataInfo, seed=None):
        self.videoLength = videoLength
        self.h = dataInfo["image"]["image_height"]
        self.w = dataInfo["image"]["image_width"]
        self.seed = seed

    def __call__(self):
        m = get_video_masks_by_moving_random_stroke(
            1, imageWidth=self.w, imageHeight=self.h, seed=self.seed)[0]
        mask = m.astype(np.float32)[:, :, None]
        return np.stack([mask] * self.videoLength, axis=0)


MASK_MODELS = {
    "random": RandomMask,
    "mid": MidRandomMask,
    "matrix": MatrixMask,
    "free_form": FreeFormMask,
    "stationary": StationaryMask,
}


def build_mask_model(name, videoLength, dataInfo, seed=None):
    return MASK_MODELS[name](videoLength, dataInfo, seed=seed)
