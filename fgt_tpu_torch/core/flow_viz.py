"""Optical flow -> colour (Middlebury colour wheel) — the port's own copy
of ``fgt_tpu/core/flow_viz.py`` (numpy only), byte-equal to it.

Two entry points mirroring the reference's two conventions:

* :func:`flow_to_rgb`   — float RGB in [0, 1]; replaces ``cvbase.flow2rgb``
  (used by LAFC metrics/datasets, reference LAFC/metrics/__init__.py:10-26).
* :func:`flow_to_image` — uint8 RGB; replaces RAFT's
  ``flow_viz.flow_to_image`` (reference RAFT/utils/flow_viz.py:109-133).

Both normalize by the maximum flow magnitude of the field and look up the
classic 55-entry Middlebury color wheel with bilinear interpolation between
adjacent wheel entries.
"""

from __future__ import annotations

import numpy as np


def _make_color_wheel() -> np.ndarray:
    """The standard 55-color Middlebury wheel, rows RGB in [0, 255]."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    # RY
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    # YG
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    # GC
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    # CB
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    # BM
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    # MR
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()
_NCOLS = _WHEEL.shape[0]


def _compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map normalized (u, v) in the unit disk to RGB floats in [0, 1]."""
    nan_mask = np.isnan(u) | np.isnan(v)
    u = np.where(nan_mask, 0.0, u)
    v = np.where(nan_mask, 0.0, v)

    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi          # [-1, 1]
    fk = (a + 1) / 2 * (_NCOLS - 1)          # [0, ncols-1]
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % _NCOLS
    f = fk - k0

    img = np.zeros(u.shape + (3,), dtype=np.float64)
    for ch in range(3):
        col0 = _WHEEL[k0, ch] / 255.0
        col1 = _WHEEL[k1, ch] / 255.0
        col = (1 - f) * col0 + f * col1
        # increase saturation with radius inside the disk; darken outside
        inside = rad <= 1
        col = np.where(inside, 1 - rad * (1 - col), col * 0.75)
        img[..., ch] = np.where(nan_mask, 0.0, col)
    return img


def flow_to_rgb(flow: np.ndarray, unknown_threshold: float = 1e9) -> np.ndarray:
    """``[H, W, 2]`` flow -> float RGB in [0, 1] (cvbase.flow2rgb contract)."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    unknown = (np.abs(u) > unknown_threshold) | (np.abs(v) > unknown_threshold)
    u = np.where(unknown, 0, u)
    v = np.where(unknown, 0, v)
    rad = np.sqrt(u ** 2 + v ** 2)
    maxrad = max(rad.max(), np.finfo(np.float64).eps)
    img = _compute_color(u / maxrad, v / maxrad)
    img[unknown] = 0
    return img.astype(np.float32)


def flow_to_image(flow: np.ndarray, rad_max: float | None = None) -> np.ndarray:
    """``[H, W, 2]`` flow -> uint8 RGB (RAFT flow_viz contract)."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    rad = np.sqrt(u ** 2 + v ** 2)
    if rad_max is None:
        rad_max = rad.max()
    eps = 1e-5
    u = u / (rad_max + eps)
    v = v / (rad_max + eps)
    img = _compute_color(u, v)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
