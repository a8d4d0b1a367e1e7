"""Stage s5's least-squares Poisson systems of a whole clip on the card —
kernel K6 (``csrc/poisson_pcg.cu``).

It replaces no Pallas kernel: the JAX package solves s5 on the host, one
scipy ``splu`` factorization a frame (``fgt_tpu/pipeline/poisson.py``, as
the port's ``pipeline/poisson.py`` still does on the CPU). On the card
the factorization is not needed: K6 solves, for every frame and colour
channel (a plane), the normal equations ``(AᵀA + 1e-8·I) x = Aᵀb`` that
``pipeline/poisson._PoissonPlan`` builds, by Jacobi-preconditioned CG in
f64, without ever forming A.

The operator, from the hole and the gradient mask alone. A hole pixel p
has an equation in direction d (E, S, W, N; q = p + d) where q lies on
the grid and the gradient is valid: ``~gm[p]`` for E and S, ``~gm[y,
x-1]`` for W, ``~gm[y-1, x]`` for N. Its source g is ``-gx[p]``,
``-gy[p]``, ``gx[y, x-1]``, ``gy[y-1, x]``. With q known the equation is
``x_p = g + I[q]``; with q in the hole it is ``x_p - x_q = g``, and q's
own equation back to p exists exactly when p's does (both test the same
gm pixel) with source -g. Summed over the equations, row p of the normal
equations reads

    (b_p + 2·i_p + 1e-8)·x_p − 2·Σ x_q = Σ_known (g + I[q]) + Σ_hole 2·g

where b_p and i_p count p's equations to known and to hole neighbours and
the sums run over them. Both the kernel and its plain twin
(:func:`poisson_pcg_plain`) solve that system; each plane stops once its
residual falls under ``RTOL`` times its right-hand side (2-norms), and a
plane that reaches ``max_iters`` first raises in :meth:`PoissonSolve.
result`. Pixels whose component reaches no known pixel have only the
ridge to set their level, so their values are not splu's; ``native.
unfilled_mask`` flags them (and others), and the pipeline leaves them to
FGT, which never reads them.

Tolerance. Jacobi-CG at ``RTOL`` = 1e-10 matches ``splu`` to 1.2e-9 on
every pixel s5 fills of the stroke cell's clip (on an H100) and to
3.4e-9 on a 2x outpainting canvas's ring frame (480x864, 311 040
unknowns, 2800 iterations; the plain version on the CPU); the pipeline
needs 1e-6 in [0, 1]. ``MAX_ITERS`` leaves that ring 7x.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from fgt_tpu_torch.ops._build import check_launch, load_cuda_library

RTOL = 1e-10         # per plane: ‖r‖ ≤ RTOL·‖Aᵀb‖
MAX_ITERS = 20000    # the 2x canvas's ring takes 2800
RIDGE = 1e-8         # pipeline/poisson.py's ridge on AᵀA


# ---------------------------------------------------------------- plain

def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], zero off the grid."""
    h, w = x.shape[-2:]
    out = torch.zeros_like(x)
    out[..., max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        x[..., max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
    return out


def _system(img, gx, gy, hole, gm):
    """Dense [n, 3, H, W] diagonal, right-hand side and the four
    coupling masks (E, S, W, N; pixel p coupled to its hole neighbour)
    of every plane, zero off the hole."""
    img, gx, gy = (t.permute(0, 3, 1, 2) for t in (img, gx, gy))
    hole = hole[:, None]
    ok = ~gm[:, None]
    # (dy, dx, gradient valid at p, source g at p)
    dirs = ((0, 1, ok, -gx), (1, 0, ok, -gy),
            (0, -1, _shift(ok, 0, -1), _shift(gx, 0, -1)),
            (-1, 0, _shift(ok, -1, 0), _shift(gy, -1, 0)))
    h, w = hole.shape[-2:]
    diag = torch.zeros(img.shape, dtype=img.dtype, device=img.device)
    rhs = torch.zeros_like(diag)
    couple = []
    for dy, dx, valid, g in dirs:
        on = torch.zeros_like(hole)
        on[..., max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = True
        eq = hole & on & valid
        q_hole = _shift(hole, dy, dx)
        inner = eq & q_hole
        known = eq & ~q_hole
        diag = diag + known + 2.0 * inner
        rhs = rhs + torch.where(known, g + _shift(img, dy, dx), 0.0) \
            + torch.where(inner, 2.0 * g, 0.0)
        couple.append(inner)
    diag = torch.where(hole, diag + RIDGE, 1.0)
    rhs = torch.where(hole, rhs, 0.0)
    return diag, rhs, couple


def poisson_pcg_plain(img, gx, gy, hole, gm, max_iters: int = MAX_ITERS):
    """Plain PyTorch version of K6, dense over [n, 3, H, W]: the same
    system and the same Jacobi-CG with per-plane stops, in f64. Returns
    what the wrapper returns: (the blended frames, img with the solution
    at its hole pixels clipped to [0, 1], [n, H, W, 3] f64; iterations
    [n, 3] int32, -1 for a plane that reached ``max_iters``
    unconverged)."""
    diag, b, couple = _system(img, gx, gy, hole, gm)
    shifts = ((0, 1), (1, 0), (0, -1), (-1, 0))

    def matvec(p):
        s = sum(torch.where(c, _shift(p, dy, dx), 0.0)
                for c, (dy, dx) in zip(couple, shifts))
        return diag * p - 2.0 * s

    def dot(a, c):
        return (a * c).sum(dim=(-2, -1))

    x = torch.zeros_like(b)
    r = b
    z = r / diag
    p = z
    rz, rr = dot(r, z), dot(r, r)
    thresh = RTOL * RTOL * rr
    iters = torch.zeros(rr.shape, dtype=torch.int32, device=rr.device)
    live = rr > thresh
    while bool(live.any()):
        if int(iters.max()) >= max_iters:
            break
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = torch.where(live, rz / torch.where(live, pap, 1.0), 0.0)
        x = x + alpha[..., None, None] * p
        r = r - alpha[..., None, None] * ap
        z = r / diag
        rz_new, rr = dot(r, z), dot(r, r)
        iters += live.to(torch.int32)
        beta = torch.where(live, rz_new / torch.where(live, rz, 1.0), 0.0)
        p = torch.where(live[..., None, None], z + beta[..., None, None] * p,
                        p)
        rz = torch.where(live, rz_new, rz)
        live = live & (rr > thresh)
    iters = torch.where(live, -1, iters)
    frames = torch.where(hole[..., None], x.permute(0, 2, 3, 1), img)
    return frames.clamp_(0.0, 1.0), iters


# ------------------------------------------------------------- wrapper

@functools.cache
def _kernel():
    fn = load_cuda_library("poisson_pcg").poisson_pcg
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
                   + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check(img, gx, gy, hole, gm) -> None:
    """Raise unless every operand is a contiguous tensor on img's CUDA
    device: img, gx, gy [n, H, W, 3] f64, hole and gm [n, H, W] bool."""
    ops = {"img": img, "gx": gx, "gy": gy, "hole": hole, "gm": gm}
    for name, t in ops.items():
        if t.device != img.device or not t.is_cuda:
            raise RuntimeError(f"poisson_pcg: {name} on {t.device}, "
                               f"expected img's CUDA device")
        want = torch.float64 if name in ("img", "gx", "gy") else torch.bool
        if t.dtype != want:
            raise TypeError(f"poisson_pcg: {name} is {t.dtype}, not {want}")
        if not t.is_contiguous():
            raise ValueError(f"poisson_pcg: {name} is not contiguous")
    if img.dim() != 4 or img.shape[3] != 3 or gx.shape != img.shape or \
            gy.shape != img.shape or hole.shape != img.shape[:3] or \
            gm.shape != img.shape[:3]:
        raise ValueError("poisson_pcg: shapes img/gx/gy [n, H, W, 3], "
                         "hole/gm [n, H, W], got "
                         f"{[tuple(t.shape) for t in ops.values()]}")


class PoissonSolve:
    """One clip's solve: on the card, its launch in flight and the
    copies back to the host queued behind it; :meth:`result` waits for
    them (the solve's one host sync)."""

    def __init__(self, frames, iters, max_iters: int, done=None):
        self.frames, self.iters, self.max_iters, self.done = \
            frames, iters, max_iters, done

    def result(self):
        """(the blended frames [n, H, W, 3] f64, iterations [n, 3] int32)
        as numpy arrays; raises if a plane reached ``max_iters``
        unconverged."""
        if self.done is not None:
            self.done.synchronize()
        frames, iters = self.frames.numpy(), self.iters.numpy()
        for code, what in ((-1, f"did not converge within {self.max_iters} "
                                "iterations"),
                           (-2, "hold another number of hole pixels than "
                                "counts gives")):
            bad = np.argwhere(iters == code)
            if bad.size:
                raise RuntimeError(f"poisson_pcg: planes (frame, channel) "
                                   f"{bad[:8].tolist()} {what}")
        return frames, iters


def poisson_pcg(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                hole: torch.Tensor, gm: torch.Tensor, counts: Sequence[int],
                max_iters: int = MAX_ITERS) -> PoissonSolve:
    """K6: every plane of a clip's Poisson blending in one launch. The
    blended frames are img with the solution at its hole pixels, clipped
    to [0, 1] as s5 keeps them (on the card, before the copy back).

    img, gx, gy: [n, H, W, 3] f64 (gx's last column and gy's last row are
    not read); hole, gm: [n, H, W] bool; counts: each frame's hole pixels
    (host ints, ``hole[i].sum()``: they size and place each frame's
    scratch without a sync). CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise) on a copy of img and queue the
    copies of the frames and the iteration counts back to the host."""
    if img.device.type == "cpu":
        return PoissonSolve(*poisson_pcg_plain(img, gx, gy, hole, gm,
                                               max_iters), max_iters)
    _check(img, gx, gy, hole, gm)
    n, h, w, _ = img.shape
    counts = [int(c) for c in counts]
    if len(counts) != n or min(counts, default=0) < 0:
        raise ValueError(f"poisson_pcg: {len(counts)} counts for {n} frames")
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    total = int(offsets[-1])
    dev = img.device
    off_t = torch.from_numpy(offsets).to(dev)
    out = img.clone()
    iters = torch.empty(n, 3, dtype=torch.int32, device=dev)
    # per plane: its pixel indices, four coupled unknowns, the diagonal
    # and the CG vectors x, r, p, Ap
    m = max(3 * total, 1)
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    nbr = torch.empty(m, 4, dtype=torch.int32, device=dev)
    vecs = torch.empty(5, m, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev)
    err = _kernel()(
        img.data_ptr(), gx.data_ptr(), gy.data_ptr(), hole.data_ptr(),
        gm.data_ptr(), off_t.data_ptr(), out.data_ptr(), iters.data_ptr(),
        idx.data_ptr(), nbr.data_ptr(), *(v.data_ptr() for v in vecs), n, h,
        w, RTOL, int(max_iters), stream.cuda_stream)
    check_launch(err, "poisson_pcg")
    poisson_pcg.launches += 1
    out.clamp_(0.0, 1.0)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in (out, iters)]
    for h_t, t in zip(host, (out, iters)):
        h_t.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    return PoissonSolve(*host, max_iters, done)


poisson_pcg.launches = 0
