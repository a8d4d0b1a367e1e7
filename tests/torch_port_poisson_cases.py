"""s5 inputs for the Poisson tests (``test_torch_port_poisson.py`` on
the CPU, ``test_torch_port_cuda.py`` on the card) and ``chip_smoke.py``'s
timing table, the pipeline's CPU loop over frames (scipy ``splu``) they
compare with, and K6's check (:func:`check_k6`). Imports no JAX."""

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


def k6_operands(video, gx, gy, holes, gms, device="cuda") -> list:
    """K6's operands of a clip on ``device``: the frames and gradients
    in f64, the masks, and each frame's hole pixels (numpy)."""
    import torch

    return ([torch.from_numpy(a).to(device).double() for a in (video, gx, gy)]
            + [torch.from_numpy(a).to(device) for a in (holes, gms)]
            + [holes.reshape(len(holes), -1).sum(1)])


def check_k6(video, gx, gy, holes, gms, device="cuda") -> dict:
    """K6 on a clip: the clip path (``poisson_blend_clip``, one launch)
    against the per-frame splu loop (the same pixels left, within 1e-6
    where Poisson fills), and the kernel on :func:`k6_operands` against
    its plain version (within 1e-7 where Poisson fills, the input
    outside the hole, every plane iterating, iterations within max(3,
    5%) of the plain version's). Raises AssertionError on a miss.
    Returns {max_abs_err (to the plain version), splu_err, iters,
    plain_iters (each [least, most]), plane_iters ([frames, 3])}."""
    import torch

    from fgt_tpu_torch.ops import poisson as k6

    def require(ok, what):
        if not ok:
            raise AssertionError(f"K6: {what}")

    before = k6.poisson_pcg.launches
    got, left = tpoisson.poisson_blend_clip(video, gx, gy, holes, gms,
                                            torch.device(device))
    require(k6.poisson_pcg.launches == before + 1, "not 1 launch")
    want, want_left = splu_clip(video, gx, gy, holes, gms)
    require(np.array_equal(left, want_left), "other pixels left than splu")
    splu_err = worst_filled_gap(got, want, holes, left)
    require(splu_err <= 1e-6, f"{splu_err:.4g} from splu")
    ops = k6_operands(video, gx, gy, holes, gms, device)
    x, iters = k6.poisson_pcg(*ops).result()
    x_twin, it_twin = k6.poisson_pcg_plain(*ops[:5])
    err = float(np.abs(x - x_twin.cpu().numpy())[holes & ~left].max())
    require(err <= 1e-7, f"{err:.4g} from the plain version")
    require(np.array_equal(x[~holes], video.astype(np.float64)[~holes]),
            "pixels outside the hole changed")
    it_twin = it_twin.cpu().numpy()
    require((iters > 0).all(), "a plane did not iterate")
    require(np.abs(iters - it_twin).max() <= max(3, 0.05 * it_twin.max()),
            f"iterations {iters.min()}-{iters.max()}, the plain version's "
            f"{it_twin.min()}-{it_twin.max()}")
    return dict(max_abs_err=err, splu_err=splu_err,
                iters=[int(iters.min()), int(iters.max())],
                plain_iters=[int(it_twin.min()), int(it_twin.max())],
                plane_iters=iters)
