"""Device Laplacian region fill ("diffusion") for flow fields.

Plain torch port of ``fgt_tpu/ops/diffusion_tpu.py`` (XLA code there, not
Pallas): solve the discrete Laplace equation inside the hole with
Dirichlet values from the hole perimeter, Neumann (reduced neighbor
count) at image borders, every un-masked pixel restored exactly. The
solver is flexible CG preconditioned by a multigrid V-cycle, batched over
all ``frames × channels`` planes with per-plane step sizes and per-plane
freezing once converged.

The loop checks convergence on the host once per iteration (a device
sync): the V-cycle keeps the count at O(10-20) independent of hole size.
The iterations a solve ran are added to the open span's counter
``pcg_iters`` (``utils/profiling.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fgt_tpu_torch.utils.profiling import count

MAX_ITERS = 600     # per-plane stop: residual below RTOL of the RHS norm
RTOL = 1e-6
LEVELS = 3          # V-cycle depth (capped by the grid size)


def _nbsum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 in-grid neighbors, zero-padded at the border."""
    up = F.pad(x[..., 1:, :], (0, 0, 0, 1))
    dn = F.pad(x[..., :-1, :], (0, 0, 1, 0))
    lf = F.pad(x[..., :, 1:], (0, 1, 0, 0))
    rt = F.pad(x[..., :, :-1], (1, 0, 0, 0))
    return up + dn + lf + rt


def _neighbor_count(h: int, w: int, device) -> torch.Tensor:
    return _nbsum(torch.ones(h, w, device=device))


def _restrict(x: torch.Tensor) -> torch.Tensor:
    """2x2-sum restriction (transpose of :func:`_prolong`); odd extents
    are zero-padded first."""
    p, h, w = x.shape
    x = F.pad(x, (0, (-w) % 2, 0, (-h) % 2))
    h2, w2 = x.shape[-2:]
    return x.reshape(p, h2 // 2, 2, w2 // 2, 2).sum((2, 4))


def _prolong(xc: torch.Tensor, shape) -> torch.Tensor:
    h, w = shape
    up = xc.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return up[:, :h, :w]


def _mask_pyramid(m: torch.Tensor, levels: int, min_size: int = 16):
    """Hole masks per level: a coarse pixel is hole iff any fine one is."""
    masks = [m]
    for _ in range(levels):
        h, w = masks[-1].shape[-2:]
        if min(h, w) // 2 < min_size:
            break
        masks.append((_restrict(masks[-1]) > 0).to(m.dtype))
    return masks


def _vcycle(r: torch.Tensor, masks, level: int = 0, nu: int = 1,
            omega: float = 0.8) -> torch.Tensor:
    """One V(nu,nu)-cycle (damped Jacobi, sum/repeat transfers, halved
    restricted residual), used only as the preconditioner."""
    m = masks[level]
    h, w = m.shape[-2:]
    n = _neighbor_count(h, w, m.device)
    ninv = omega * m / torch.clamp(n, min=1.0)

    def matvec(x):
        return (n * x - _nbsum(x)) * m

    def smooth(x, b, iters):
        for _ in range(iters):
            x = x + (b - matvec(x)) * ninv
        return x

    if level == len(masks) - 1:
        return smooth(torch.zeros_like(r), r, 24)
    x = smooth(torch.zeros_like(r), r, nu)
    rc = _restrict((r - matvec(x)) * 0.5) * masks[level + 1]
    xc = _vcycle(rc, masks, level + 1, nu, omega)
    x = x + _prolong(xc, (h, w)) * m
    return smooth(x, r, nu)


def _pcg_hole_solve(planes, m, keep, masks):
    h, w = planes.shape[-2:]
    b = _nbsum(planes * keep) * m
    n = _neighbor_count(h, w, planes.device) * m

    def matvec(x):
        return (n * x - _nbsum(x)) * m

    def dot(a, c):
        return (a * c).sum(dim=(-2, -1), keepdim=True)

    tol2 = (RTOL * RTOL) * dot(b, b)
    x = torch.zeros_like(planes)
    r = b
    z = _vcycle(b, masks)
    p = z
    rz = dot(b, z)
    rs = dot(b, b)
    iters = 0
    for _ in range(MAX_ITERS):
        live_b = rs > tol2
        if not bool(live_b.any()):
            break
        iters += 1
        live = live_b.float()
        ap = matvec(p)
        denom = dot(p, ap)
        alpha = live * rz / torch.where(denom > 0, denom, torch.ones_like(denom))
        x = x + alpha * p
        r_new = r - alpha * ap
        z_new = _vcycle(r_new, masks)
        rz_new = dot(r_new, z_new)
        # flexible (Polak-Ribiere) beta tolerates the cycle's asymmetry
        beta = live * (rz_new - dot(r_new, z)) / torch.where(
            rz > 0, rz, torch.ones_like(rz))
        p = z_new + beta * p
        r, z, rz, rs = r_new, z_new, rz_new, dot(r_new, r_new)
    count("pcg_iters", iters)
    return x


def laplace_fill_planes(planes: torch.Tensor,
                        hole: torch.Tensor) -> torch.Tensor:
    """planes: [P, H, W]; hole: [P, H, W] (bool or {0,1}). Returns f32
    [P, H, W] with hole pixels Laplace-filled, others exactly kept."""
    planes = planes.float()
    m = (hole > 0).float()
    keep = 1.0 - m
    x = _pcg_hole_solve(planes, m, keep, _mask_pyramid(m, LEVELS))
    return planes * keep + x * m


def diffuse_flows_device(flows: torch.Tensor,
                         masks: torch.Tensor) -> torch.Tensor:
    """flows: [T, H, W, 2]; masks: [T, H, W] or [T, H, W, 1]. Returns
    [T, H, W, 2] f32 diffusion-filled flows."""
    if masks.dim() == 4:
        masks = masks[..., 0]
    t, h, w, c = flows.shape
    planes = flows.permute(0, 3, 1, 2).reshape(t * c, h, w)
    hole = masks[:, None].expand(t, c, h, w).reshape(t * c, h, w)
    out = laplace_fill_planes(planes, hole)
    return out.reshape(t, c, h, w).permute(0, 2, 3, 1)
