"""Poisson blending of propagated gradients into frames, stage s5 — the
port's own copy of ``fgt_tpu/pipeline/poisson.py`` (reference
tool/utils/Poisson_blend_img.py).

For every hole pixel p and 4-neighbor q (E, S, W, N) one least-squares
equation ties x_p to the propagated gradient: against the known value
when q is outside the hole, against x_q when q is a hole too. Equations
are skipped where the gradient itself is still masked. The system is
solved through its normal equations with one sparse LU factorization
(scipy ``splu``) shared by the RGB channels. Unknowns are the hole
pixels only. The connectivity check (hole pixels unreachable through
gradient-valid paths) is the native ``unfilled_mask``.

On a CUDA device the pipeline takes :func:`poisson_blend_clip` instead:
the same normal equations of every frame, solved on the card in one
launch of kernel K6 (``ops/poisson.py``), with no factorization.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import torch
from scipy import sparse
from scipy.sparse.linalg import splu

from fgt_tpu_torch import native
from fgt_tpu_torch.ops.poisson import poisson_pcg
from fgt_tpu_torch.utils.profiling import count


class _PoissonPlan:
    """Everything determined by (hole, gm): the equation system (all ±1
    coefficients), its factorization, and the gather plan of the RHS."""

    def __init__(self, hole: np.ndarray, gm: np.ndarray):
        H, W = hole.shape
        py, px = np.nonzero(hole)
        self.py, self.px = py, px
        npix = py.size
        col_of = np.full((H, W), -1, np.int64)
        col_of[py, px] = np.arange(npix)

        rows, cols, vals = [], [], []
        rhs_plan = []
        eq = 0
        # (dy, dx, gradient source, gradient-valid test); sources:
        # 0 = -gx[y, x], 1 = -gy[y, x], 2 = gx[y, x-1], 3 = gy[y-1, x]
        dirs = (
            (0, 1, 0, lambda y, x: ~gm[y, x]),          # E
            (1, 0, 1, lambda y, x: ~gm[y, x]),          # S
            (0, -1, 2, lambda y, x: ~gm[y, x - 1]),     # W
            (-1, 0, 3, lambda y, x: ~gm[y - 1, x]),     # N
        )
        for dy, dx, gsrc, gok in dirs:
            qy, qx = py + dy, px + dx
            valid = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
            vy, vx = py[valid], px[valid]
            qy, qx = qy[valid], qx[valid]
            havegrad = gok(vy, vx)
            q_known = ~hole[qy, qx]
            # boundary equations: x_p = grad + I[q]
            selb = havegrad & q_known
            n = int(selb.sum())
            rows.append(np.arange(eq, eq + n))
            cols.append(col_of[vy[selb], vx[selb]])
            vals.append(np.ones(n))
            rhs_plan.append(("b", gsrc, vy[selb], vx[selb], qy[selb],
                             qx[selb]))
            eq += n
            # interior equations: x_p - x_q = grad
            seli = havegrad & ~q_known
            n = int(seli.sum())
            rows.append(np.arange(eq, eq + n))
            cols.append(col_of[vy[seli], vx[seli]])
            vals.append(np.ones(n))
            rows.append(np.arange(eq, eq + n))
            cols.append(col_of[qy[seli], qx[seli]])
            vals.append(-np.ones(n))
            rhs_plan.append(("i", gsrc, vy[seli], vx[seli], None, None))
            eq += n

        self.rhs_plan = rhs_plan
        self.A = sparse.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))),
            shape=(eq, npix))
        # the 1e-8 ridge keeps equation-less pixels at the minimum-norm 0
        # that LSQR would give and makes the system nonsingular
        self.lu = splu((self.A.T @ self.A + 1e-8 * sparse.eye(npix)).tocsc())
        self.unfilled = native.unfilled_mask(hole, gm)

    def rhs(self, img_target, gx, gy):
        srcs = (lambda y, x: -gx[y, x], lambda y, x: -gy[y, x],
                lambda y, x: gx[y, x - 1], lambda y, x: gy[y - 1, x])
        parts = []
        for kind, gsrc, vy, vx, qy, qx in self.rhs_plan:
            b_dir = srcs[gsrc](vy, vx)
            parts.append(b_dir + img_target[qy, qx] if kind == "b" else b_dir)
        return np.concatenate(parts, axis=0)


def poisson_blend(img_target: np.ndarray, grad_x: np.ndarray,
                  grad_y: np.ndarray, hole_mask: np.ndarray,
                  gradient_mask: np.ndarray):
    """Blend gradients into the hole of one frame.

    img_target: [H, W, 3]; grad_x: [H, W-1, 3]; grad_y: [H-1, W, 3];
    hole_mask, gradient_mask: [H, W] bool-ish.
    Returns (blended [H, W, 3] f64, unfilled mask [H, W] bool). The
    unknowns solved (the hole's pixels) are added to the open span's
    counter ``poisson_px``."""
    H, W, C = img_target.shape
    hole = hole_mask.astype(bool)
    gm = gradient_mask.astype(bool)
    if not hole.any():
        return img_target.astype(np.float64), np.zeros((H, W), bool)
    gx = np.zeros((H, W, C), np.float64)
    gy = np.zeros((H, W, C), np.float64)
    gx[:, :grad_x.shape[1]] = grad_x
    gy[:grad_y.shape[0], :] = grad_y
    plan = _PoissonPlan(hole, gm)
    count("poisson_px", plan.py.size)
    recon = plan.lu.solve(plan.A.T @ plan.rhs(img_target, gx, gy))
    out = img_target.astype(np.float64).copy()
    out[plan.py, plan.px] = recon
    return out, plan.unfilled.copy()


def fill_holes(masks: np.ndarray) -> np.ndarray:
    """``scipy.ndimage.binary_fill_holes`` of every frame of [n, H, W]
    bool masks at once: a pixel outside the mask is filled where its
    4-connected component outside the mask, within its frame, touches no
    border of the frame. One labelling pass over the clip instead of a
    dilation to convergence a frame (a third of the time on a stroke
    clip)."""
    plane_cross = np.zeros((3, 3, 3), bool)
    plane_cross[1] = scipy.ndimage.generate_binary_structure(2, 1)
    labels, n = scipy.ndimage.label(~np.asarray(masks, bool), plane_cross)
    outside = np.zeros(n + 1, bool)
    for edge in (labels[:, 0], labels[:, -1], labels[:, :, 0],
                 labels[:, :, -1]):
        outside[edge] = True
    outside[0] = False
    return ~outside[labels]


def poisson_blend_clip(video: np.ndarray, gx: np.ndarray, gy: np.ndarray,
                       holes: np.ndarray, gms: np.ndarray, device):
    """Blend gradients into the holes of every frame of a clip at once,
    through K6 on ``device`` (its plain twin on the CPU).

    video, gx, gy: [n, H, W, 3] (gx's last column and gy's last row are
    not read); holes, gms: [n, H, W] bool. Returns (blends: per frame the
    [H, W, 3] f64 blend clipped to [0, 1], or the frame itself where it
    has no hole; the pixels left unfilled [n, H, W] bool), what the
    per-frame :func:`poisson_blend` loop of the pipeline gives. The
    unknowns are added to the open span's counter ``poisson_px``, the
    most iterations of any plane to ``poisson_iters``."""
    holes = np.asarray(holes, bool)
    gms = np.asarray(gms, bool)
    counts = holes.reshape(len(holes), -1).sum(1)
    count("poisson_px", int(counts.sum()))

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device).to(dtype)

    solve = poisson_pcg(up(video, torch.float64), up(gx, torch.float64),
                        up(gy, torch.float64), up(holes, torch.bool),
                        up(gms, torch.bool), counts)
    left = holes.copy()         # the card solves meanwhile
    for i in np.flatnonzero(counts):
        left[i] = native.unfilled_mask(holes[i], gms[i])
    frames, iters = solve.result()
    count("poisson_iters", int(iters.max(initial=0)))
    return [frames[i] if c else video[i] for i, c in enumerate(counts)], left
