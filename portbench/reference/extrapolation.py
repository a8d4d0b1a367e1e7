"""Video extrapolation by the plain reference: the canvas step (s1b) and
the stages that run on the canvas.

:func:`extrapolation` is a frozen copy of ``extrapolation`` in
``fgt_tpu_torch/pipeline/video_inpainting.py`` (commit 0a1b06d), itself
after the reference CLI's ``tool/video_inpainting.py:291-339``: the
canvas is int(s·h) - int(s·h) % 4 per axis, the frames and the flows
are centred in it with a zero border, and the border is the hole (not
dilated), with its gradient mask.

:func:`s3_s6` is :func:`portbench.reference.pipeline.s3_s6` on the
canvas: s3-s5 of :mod:`portbench.reference.host`, its Poisson frames
solved on a pool of threads (each frame's system is its own, so the
frames come out as the loop of ``host.propagate`` gives them; a ring of
311 040 unknowns takes seconds to factor), then FGT one window at a
time (at L 9360 the plain attention's f32 scores of one window take
5.6 GB, of the default two 11.2 GB, each with its softmax beside it).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.ndimage
import torch

from portbench.reference import host
from portbench.reference.pipeline import RefModels, s6_fgt


def extrapolation(video: np.ndarray, flows_f: torch.Tensor,
                  flows_b: torch.Tensor, h_scale: float, w_scale: float):
    """video [N, H, W, 3] f32 (any range: it is only placed); flows
    [N-1, H, W, 2]. Returns (canvas video, padded flows_f, flows_b,
    border mask [h2, w2] bool, its gradient mask)."""
    n, h, w, _ = video.shape
    h2 = int(h_scale * h) - int(h_scale * h) % 4
    w2 = int(w_scale * w) - int(w_scale * w) % 4
    y0, x0 = (h2 - h) // 2, (w2 - w) // 2
    flow_mask = np.ones((h2, w2), dtype=bool)
    flow_mask[y0:y0 + h, x0:x0 + w] = False
    big = np.zeros((n, h2, w2, 3), np.float32)
    big[:, y0:y0 + h, x0:x0 + w] = video
    padded = []
    for fl in (flows_f, flows_b):
        p = fl.new_zeros(fl.shape[0], h2, w2, 2)
        p[:, y0:y0 + h, x0:x0 + w] = fl
        padded.append(p)
    return (big, padded[0], padded[1], flow_mask,
            host.gradient_mask(flow_mask))


def centre(h: int, w: int, h2: int, w2: int) -> tuple:
    """The slices of the canvas that hold the frames."""
    y0, x0 = (h2 - h) // 2, (w2 - w) // 2
    return slice(y0, y0 + h), slice(x0, x0 + w)


def propagate(frames255, masks, flow_f, flow_b, thres=5.0, alpha=0.1):
    """``host.propagate`` with the frames' Poisson systems solved on a
    pool of threads."""
    video = np.asarray(frames255, np.float32) / 255.0
    mask = np.asarray(masks) > 0
    mask_dilated = np.stack([host.gradient_mask(m) for m in mask])
    video, gx, gy = host.prepare_gradients(video, mask, mask_dilated)
    gx, gy, tofill = host.flownn(gx, gy, mask, flow_f, flow_b, thres, alpha)
    tofill = np.stack([scipy.ndimage.binary_fill_holes(m) for m in tofill])
    n, h, w = mask.shape

    def frame(i):
        if not mask[i].any():
            return video[i], mask[i]
        blend, unfilled = host.poisson_blend(video[i], gx[i][:, :w - 1],
                                             gy[i][:h - 1], mask[i],
                                             tofill[i])
        return np.clip(blend, 0, 1.0), unfilled

    with ThreadPoolExecutor(min(n, os.cpu_count() or 1)) as pool:
        blends, left = zip(*pool.map(frame, range(n)))
    return np.stack(blends), np.stack(left)


def s3_s6(m: RefModels, canvas255: np.ndarray, border: np.ndarray,
          comp_f: torch.Tensor, comp_b: torch.Tensor):
    """Host propagation and Poisson, then FGT, on the canvas frames
    [N, H2, W2, 3] in [0, 255] with the border [N, H2, W2] as the hole,
    from completed flows. Returns (u8 [N, H2, W2, 3], the pixels left for
    FGT [N, H2, W2] bool)."""
    blends, left = propagate(canvas255, border, comp_f.cpu().numpy(),
                             comp_b.cpu().numpy())
    u8 = np.clip(np.round(blends * 255.0), 0, 255).astype(np.uint8)
    return s6_fgt(m, torch.from_numpy(u8).to(m.device),
                  torch.from_numpy(left.astype(np.uint8)).to(m.device),
                  comp_f, window_chunk=1).cpu().numpy(), left
