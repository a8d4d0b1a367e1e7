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
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.linalg import splu

from fgt_tpu_torch import native
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
