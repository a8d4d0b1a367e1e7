"""s2 diffusion inputs for K7's card tests (``test_torch_port_cuda.py``)
and ``chip_smoke.py``'s timing table, the counters a solve records, and
K7's check (:func:`check_k7`). Imports no JAX."""

import math

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


def check_k7(planes, hole) -> dict:
    """K7 on (planes, hole) against its plain version: one launch; inside
    the hole within 1e-4 of the planes' scale, outside it the input's
    bits; iterations within 2 of the plain version's and inside (0,
    MAX_ITERS); the plain version reading its flag once an iteration and
    once more, K7 at most ⌈iterations / CHUNK⌉ + 2 times. K7 is called as
    ``laplace_fill_planes`` calls it on f32 planes and a bool hole.
    Raises AssertionError on a miss. Returns {max_abs_err, iters,
    plain_iters, syncs, plane_iters ([P] on the card)}."""
    from fgt_tpu_torch.ops import diffusion as k7

    def require(ok, what):
        if not ok:
            raise AssertionError(f"K7: {what}")

    before = k7.diffusion_mg.launches
    (got, plane_iters), mine = counted(k7.diffusion_mg, planes, hole, True)
    require(k7.diffusion_mg.launches == before + 1, "not 1 launch")
    want, plain = counted(k7.laplace_fill_planes_plain, planes, hole)
    scale = planes.abs().max().item()
    err = (got - want)[hole].abs().max().item()
    require(err <= 1e-4 * scale, f"{err:.4g} from the plain version "
            f"(scale {scale:.4g})")
    require(torch.equal(got.view(torch.int32)[~hole],
                        planes.view(torch.int32)[~hole]),
            "pixels outside the hole changed")
    iters, syncs = mine["pcg_iters"], mine["pcg_syncs"]
    require(abs(iters - plain["pcg_iters"]) <= 2 and 0 < iters < k7.MAX_ITERS,
            f"{iters} iterations, the plain version's {plain['pcg_iters']}")
    require(plain["pcg_syncs"] == plain["pcg_iters"] + 1,
            f"the plain version's {plain['pcg_syncs']} host reads")
    require(syncs <= math.ceil(iters / k7.CHUNK) + 2, f"{syncs} host reads")
    return dict(max_abs_err=err, iters=iters, plain_iters=plain["pcg_iters"],
                syncs=syncs, plane_iters=plane_iters)
