"""s2 diffusion inputs for K7's card tests (``test_torch_port_cuda.py``)
and ``chip_smoke.py``'s K7 phase, and the counters a solve records.
Imports no JAX."""

import numpy as np
import torch

from fgt_tpu_torch.utils import profiling
from portbench.traffic import stroke_masks


def case(kind, p, h, w, device="cuda"):
    """(planes [p, h, w] f32, hole [p, h, w] bool) on ``device``: smooth
    flow channels of a few px, each flow's two channels sharing a hole.
    ``strokes``: the stroke cell's moving strokes (mask seed 0);
    ``square``: a box of w/6 moving 2 px a flow (the square cell's 56 px
    dilated by 8 at w 432); ``ring``: the 2x canvas's border around its
    centred frame."""
    n = (p + 1) // 2
    if kind == "strokes":
        holes = stroke_masks(n, h, w, 0) > 0
    elif kind == "square":
        side = max(1, w // 6)
        holes = np.zeros((n, h, w), bool)
        for i in range(n):
            y0 = (h - side) // 2
            x0 = min(w - side, w // 4 + 2 * i)
            holes[i, y0:y0 + side, x0:x0 + side] = True
    else:
        holes = np.ones((n, h, w), bool)
        holes[:, h // 4:h // 4 + h // 2, w // 4:w // 4 + w // 2] = False
    holes = np.repeat(holes, 2, axis=0)[:p]
    yy, xx = np.mgrid[0:h, 0:w] / float(w)
    planes = np.stack([6 * np.sin(3 * xx + 0.3 * i) * np.cos(2 * yy - 0.2 * i)
                       + (i % 2) for i in range(p)]).astype(np.float32)
    return (torch.from_numpy(planes).to(device),
            torch.from_numpy(holes).to(device))


def counted(fn, *args):
    """fn(*args) inside one recorded span: (its result, the span's
    counters)."""
    profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        with profiling.span("solve"):
            out = fn(*args)
    finally:
        profiling.enable_spans(False)
    (rec,) = profiling.spans()
    return out, rec["counters"]
