"""s5 inputs for the Poisson tests (``test_torch_port_poisson.py`` on
the CPU, ``test_torch_port_cuda.py`` on the card), and the pipeline's CPU
loop over frames (scipy ``splu``) they compare with. Imports no JAX."""

import numpy as np

from fgt_tpu_torch.pipeline import poisson as tpoisson
from portbench.traffic import stroke_masks


def _closed_ring(gm, hole, y0, x0, size):
    """Mask the gradients on a 2-px frame of a ``size`` box at (y0, x0),
    all hole: the box's inside then has equations only among its own
    pixels."""
    hole[y0:y0 + size, x0:x0 + size] = True
    gm[y0:y0 + size, x0:x0 + size] = True
    gm[y0 + 2:y0 + size - 2, x0 + 2:x0 + size - 2] = False


def case(kind, n=None, h=None, w=None):
    """(video, gx, gy, holes, gms) as s5 receives them: f32 frames in
    [0, 1], forward differences with noise, bool masks with a closed
    ring of masked gradients and a masked patch in every frame that has
    a hole. ``strokes``: the stroke cell's moving strokes (mask seed 0),
    its last frame without a hole at the default 3 x 64 x 96; ``square``:
    a 56x56 hole; ``ring``: the 2x canvas around a centred frame."""
    if kind == "strokes":
        n, h, w = n or 3, h or 64, w or 96
        holes = stroke_masks(n, h, w, 0) > 0
        if n == 3:
            holes[2] = False
    elif kind == "square":
        n, h, w = n or 2, h or 72, w or 96
        holes = np.zeros((n, h, w), bool)
        for i in range(n):
            holes[i, 8 + i:64 + i, 20 + 2 * i:76 + 2 * i] = True
    else:
        n, h, w = n or 2, h or 48, w or 80
        holes = np.ones((n, h, w), bool)
        holes[:, h // 4:h // 4 + h // 2, w // 4:w // 4 + w // 2] = False
    rng = np.random.RandomState(1)
    yy, xx = np.mgrid[0:h, 0:w] / float(w)
    video = np.stack([np.stack([0.5 + 0.4 * np.sin(3 * xx + c + i)
                                * np.cos(2 * yy - c) for c in range(3)], -1)
                      for i in range(n)]).astype(np.float32)
    gx = np.zeros_like(video)
    gy = np.zeros_like(video)
    gx[:, :, :-1] = np.diff(video, axis=2)
    gy[:, :-1] = np.diff(video, axis=1)
    gx += 0.01 * rng.randn(*gx.shape).astype(np.float32)
    gy += 0.01 * rng.randn(*gy.shape).astype(np.float32)
    gms = np.zeros_like(holes)
    for i in range(n):
        if holes[i].any():
            _closed_ring(gms[i], holes[i], 1, 2, 9)
            gms[i, h - 12:h - 6, w - 14:w - 4] = True
            gms[i] &= holes[i] | (rng.rand(h, w) < 0.5)
    return video, gx, gy, holes, gms


def splu_clip(video, gx, gy, holes, gms):
    """The pipeline's CPU loop over frames: (blends, pixels left)."""
    h, w = holes.shape[1:]
    blends, left = [], holes.copy()
    for i in range(len(holes)):
        if holes[i].any():
            blend, unfilled = tpoisson.poisson_blend(
                video[i], gx[i][:, :w - 1], gy[i][:h - 1], holes[i], gms[i])
            blends.append(np.clip(blend, 0, 1.0))
            left[i] = unfilled
        else:
            blends.append(video[i])
    return blends, left


def worst_filled_gap(got, want, holes, left) -> float:
    """Largest |got - want| over the pixels Poisson fills."""
    filled = holes & ~left
    return max((float(np.abs(g - w)[f].max(initial=0.0))
                for g, w, f in zip(got, want, filled)), default=0.0)
