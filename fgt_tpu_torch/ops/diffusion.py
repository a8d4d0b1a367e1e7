"""Device Laplacian region fill ("diffusion") for flow fields.

Port of ``fgt_tpu/ops/diffusion_tpu.py`` (XLA code there, not Pallas):
solve the discrete Laplace equation inside the hole with Dirichlet
values from the hole perimeter, Neumann (reduced neighbor count) at image
borders, every un-masked pixel restored exactly. The solver is flexible
CG preconditioned by a multigrid V-cycle, batched over all ``frames ×
channels`` planes with per-plane step sizes and per-plane freezing once
converged.

CUDA tensors take kernel K7 (``csrc/diffusion_mg.cu``, :func:`diffusion_mg`):
the same solver in ~10 launches an iteration, its scalars on the card,
the host reading convergence once every :data:`CHUNK` iterations. CPU
tensors take the plain twin (:func:`laplace_fill_planes_plain`), which
reads convergence on the host once an iteration. Both add the
iterations in which some plane was live to the open span's counter
``pcg_iters`` and their host reads of the convergence flag to
``pcg_syncs`` (``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from fgt_tpu_torch.ops._build import check_launch, load_cuda_library
from fgt_tpu_torch.utils.profiling import count

MAX_ITERS = 600     # per-plane stop: residual below RTOL of the RHS norm
RTOL = 1e-6
LEVELS = 3          # V-cycle depth (capped by the grid size)
MIN_SIZE = 16       # no level below this many pixels on its shorter side
CHUNK = 8           # K7's iterations between two host reads of the flag


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


def level_shapes(h: int, w: int) -> list:
    """The V-cycle's grids of an [h, w] plane, finest first: up to
    ``LEVELS`` halvings, none to a side under ``MIN_SIZE``."""
    shapes = [(h, w)]
    for _ in range(LEVELS):
        hh, ww = shapes[-1]
        if min(hh, ww) // 2 < MIN_SIZE:
            break
        shapes.append(((hh + 1) // 2, (ww + 1) // 2))
    return shapes


def _mask_pyramid(m: torch.Tensor):
    """Hole masks per level of :func:`level_shapes`: a coarse pixel is
    hole iff any fine one is."""
    masks = [m]
    for _ in level_shapes(*m.shape[-2:])[1:]:
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
    iters = syncs = 0
    for _ in range(MAX_ITERS):
        live_b = rs > tol2
        syncs += 1
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
    count("pcg_syncs", syncs)
    return x


def laplace_fill_planes_plain(planes: torch.Tensor,
                              hole: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 (any device): :func:`laplace_fill_planes`
    by eager passes, one host read of convergence an iteration."""
    planes = planes.float()
    m = (hole > 0).float()
    keep = 1.0 - m
    x = _pcg_hole_solve(planes, m, keep, _mask_pyramid(m))
    return planes * keep + x * m


# ------------------------------------------------------------------ K7

_SPAN = 256 * 4     # pixels a block of K7's fine-grid passes (kSpan)
_LEVELS_MAX = 4     # kMaxLevels: LEVELS halvings give at most 4 grids


class _Args(ctypes.Structure):
    """``MgArgs`` of ``csrc/diffusion_mg.cu``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("planes", "hole", "x", "r",
                                                "z")]
                + [("p", ctypes.c_void_p * 2)]
                + [(n, ctypes.c_void_p) for n in (
                    "part_a", "part_b", "part_u", "scal", "live",
                    "plane_iters", "count", "sweep", "top_tmp")]
                + [(n, ctypes.c_void_p * _LEVELS_MAX)
                   for n in ("mask", "rc", "xc")]
                + [("n_planes", ctypes.c_int),
                   ("h", ctypes.c_int * _LEVELS_MAX),
                   ("w", ctypes.c_int * _LEVELS_MAX),
                   ("levels", ctypes.c_int), ("nb", ctypes.c_int),
                   ("coarse_shared", ctypes.c_int)])


@functools.cache
def _lib():
    lib = load_cuda_library("diffusion_mg")
    for name, extra in (("k7_setup", []),
                        ("k7_iterate", [ctypes.c_int, ctypes.c_int]),
                        ("k7_finish", [])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_Args)] + extra + [ctypes.c_void_p]
    lib.k7_smem_limit.restype = ctypes.c_int
    lib.k7_smem_limit.argtypes = [ctypes.c_int]
    if lib.k7_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("diffusion_mg: MgArgs and _Args differ in size")
    return lib


def coarse_in_shared(h: int, w: int, device) -> bool:
    """Whether K7 sweeps the coarsest level of [h, w] planes in one block a
    plane, its x (twice), right-hand side and mask in shared memory; if
    not, in 24 launches over global memory."""
    hc, wc = level_shapes(h, w)[-1]
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    need = 12 * hc * wc + (hc * wc + 3) // 4 * 4
    return need <= _lib().k7_smem_limit(index)


def _check(planes: torch.Tensor, hole: torch.Tensor) -> None:
    """Raise unless planes is a contiguous [P, H, W] f32 CUDA tensor and
    hole a contiguous bool tensor of its shape on its device."""
    for name, t in (("planes", planes), ("hole", hole)):
        if not t.is_cuda or t.device != planes.device:
            raise RuntimeError(f"diffusion_mg: {name} on {t.device}, "
                               f"expected the planes' CUDA device")
    for name, t, want in (("planes", planes, torch.float32),
                          ("hole", hole, torch.bool)):
        if t.dtype != want:
            raise TypeError(f"diffusion_mg: {name} is {t.dtype}, not {want}")
        if not t.is_contiguous():
            raise ValueError(f"diffusion_mg: {name} is not contiguous")
    if planes.dim() != 3 or hole.shape != planes.shape:
        raise ValueError(f"diffusion_mg: planes and hole [P, H, W] alike, "
                         f"got {tuple(planes.shape)} and "
                         f"{tuple(hole.shape)}")


def diffusion_mg(planes: torch.Tensor, hole: torch.Tensor,
                 plane_iters: bool = False):
    """K7: :func:`laplace_fill_planes` of CUDA planes on the card.

    planes: [P, H, W] f32, hole: [P, H, W] bool, both contiguous on one
    CUDA device (anything else raises). Returns [P, H, W] f32, the hole
    Laplace-filled and every other pixel the input's bits; with
    ``plane_iters`` also each plane's iterations ([P] int32 on the card).
    The host issues :data:`CHUNK` iterations at a time and reads one flag
    after each chunk (``pcg_syncs`` counts the reads); an iteration after
    a plane froze leaves it as it is, so a chunk that overruns changes
    nothing."""
    _check(planes, hole)
    n, h, w = planes.shape
    dev = planes.device
    if planes.numel() == 0:
        out = planes.clone()
        return (out, torch.zeros(n, dtype=torch.int32, device=dev)) \
            if plane_iters else out
    shapes = level_shapes(h, w)
    top = len(shapes) - 1
    nb = -(-h * w // _SPAN)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    x, r, z, p0, p1 = (torch.empty_like(planes) for _ in range(5))
    part = torch.empty(4, n, nb, **f32)       # p.Ap, r.r, r.z_new, r.z_old
    scal = torch.empty(n, 4, **f32)
    live = torch.ones(n, **i32)
    iters = torch.zeros(n, **i32)
    counts = torch.zeros(2, **i32)
    grids = [(torch.empty(n, hh, ww, dtype=torch.uint8, device=dev),
              torch.empty(n, hh, ww, **f32), torch.empty(n, hh, ww, **f32))
             for hh, ww in shapes[1:]]
    shared = coarse_in_shared(h, w, dev)
    sweep = None if shared else torch.empty(n, *shapes[-1], **f32)
    top_tmp = torch.empty_like(planes) if top == 0 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    def level_ptrs(k):
        return [None] + [ptr(g[k]) for g in grids] + \
            [None] * (_LEVELS_MAX - 1 - len(grids))

    args = _Args(
        ptr(planes), ptr(hole), ptr(x), ptr(r), ptr(z),
        (ctypes.c_void_p * 2)(ptr(p0), ptr(p1)), ptr(part[0]),
        ptr(part[1]), ptr(part[2]), ptr(scal), ptr(live), ptr(iters),
        ptr(counts), ptr(sweep), ptr(top_tmp),
        *((ctypes.c_void_p * _LEVELS_MAX)(*level_ptrs(k)) for k in range(3)),
        n, (ctypes.c_int * _LEVELS_MAX)(*[s[0] for s in shapes]),
        (ctypes.c_int * _LEVELS_MAX)(*[s[1] for s in shapes]), len(shapes),
        nb, int(shared))
    lib, ref = _lib(), ctypes.byref(args)
    host = torch.empty(2, dtype=torch.int32, pin_memory=True)
    syncs = done = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check_launch(lib.k7_setup(ref, stream), "diffusion_mg")
        while True:
            host.copy_(counts, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            syncs += 1
            if not int(host[1]) or done >= MAX_ITERS:
                break
            k = min(CHUNK, MAX_ITERS - done)
            check_launch(lib.k7_iterate(ref, done, k, stream),
                         "diffusion_mg")
            done += k
        check_launch(lib.k7_finish(ref, stream), "diffusion_mg")
    diffusion_mg.launches += 1
    count("pcg_iters", lambda: int(host[0]))
    count("pcg_syncs", syncs)
    return (x, iters) if plane_iters else x


diffusion_mg.launches = 0


def laplace_fill_planes(planes: torch.Tensor,
                        hole: torch.Tensor) -> torch.Tensor:
    """planes: [P, H, W]; hole: [P, H, W] (bool or {0,1}). Returns f32
    [P, H, W] with hole pixels Laplace-filled, others exactly kept. CUDA
    planes take K7 (a hole elsewhere raises), others the plain twin."""
    if planes.device.type == "cuda":
        return diffusion_mg(planes.float().contiguous(),
                            (hole > 0).contiguous())
    return laplace_fill_planes_plain(planes, hole)


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
