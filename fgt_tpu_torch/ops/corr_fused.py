"""RAFT correlation lookup from pooled feature corners — kernel K1.

Replaces the TPU kernel ``fgt_tpu/ops/corr_fused_pallas.py::_fused_kernel``
(called through ``lookup_corr_fused``). Contract: for every pixel and
pyramid level l, the (2r+1)^2 bilinear taps of the level-l correlation
map at coords/2^l, with corr = f1·f2/√C, taps outside a level exactly
zero, floor pooling on odd sizes, output [B, H, W, L·k²] with dx slow and
dy fast within a level, in the feature dtype.

Design for Hopper (``csrc/corr_fused.cu``). The TPU kernel keeps a pair's
whole level-0 fmap2 (≈4 MB in bf16) in VMEM and builds a correlation slab
from it; an H100 block has 227 KB of shared memory, so that design does
not carry over. Average-pooling the correlation equals correlating with
average-pooled features (pooling is linear), so — the reference
AlternateCorrBlock contract — each level needs only the (k+1)² corner
dots of f1 with that level's pooled fmap2; all k² taps share one
bilinear fraction. That is L·(k+1)²·C ≈ 102k MACs per pixel per GRU
iteration instead of H0·W0·C ≈ 1.7M for a level-0 slab. One warp serves
one pixel: f1 sits in registers pre-scaled by 1/√C, 8-lane groups each
take one corner (16-byte coalesced loads of the channels-last corner
vector, f32 accumulation, 3 shuffles), the corner dots go to shared
memory and the warp writes the 81 taps of the level.

Bound on the card: at the main-path shape (46 pairs × 60×108 pixels,
C = 256, bf16) one launch must move ≈0.55 GB (f1, pooled fmap2, coords,
taps) and do at most ≈61 GFLOP (less where corners fall outside a
level), so bytes bound it (≈0.16 ms at 3.35 TB/s). The corner gathers
re-read fmap2 from L2, not HBM: one pair's level-0 fmap2 (3.3 MB) stays
L2-resident while its pixels are processed.

The pooled pyramid is built once per refine call with plain torch
(:func:`build_fmap_pyramid`), outside the GRU loop.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from fgt_tpu_torch.ops._build import check_launch, load_cuda_library

MAX_LEVELS = 6
MAX_RADIUS = 7
PLAIN_CHUNK = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build_fmap_pyramid(fmap2: torch.Tensor, num_levels: int = 4,
                       dtype: torch.dtype | None = None) -> list:
    """Average-pooled FEATURE pyramid (floor on odd sizes, like
    ``avg_pool2d(2, 2)``): [B, H, W, C] -> list of [B, H_l, W_l, C]
    channels-last contiguous levels. Pools in f32, stores in ``dtype``
    (default: fmap2's)."""
    dtype = dtype or fmap2.dtype
    x = fmap2.float().permute(0, 3, 1, 2)
    levels = [x]
    for _ in range(num_levels - 1):
        levels.append(F.avg_pool2d(levels[-1], 2, 2))
    return [lv.permute(0, 2, 3, 1).contiguous().to(dtype) for lv in levels]


def lookup_corr_plain(fmap1: torch.Tensor, pyramid: list,
                      coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch version of K1: gather the corner vectors, dot them
    with f1 in f32, combine the taps. Same inputs and output contract as
    :func:`lookup_corr_fused`; pixels go in chunks of PLAIN_CHUNK to bound
    the gathered temporary."""
    B, H, W, C = fmap1.shape
    N = B * H * W
    k = 2 * radius + 1
    kk = k * k
    dt = pyramid[0].dtype
    f1 = fmap1.reshape(N, C).to(dt).float() * (1.0 / math.sqrt(C))
    flat = coords.reshape(N, 2).float()
    bidx = torch.arange(B, device=fmap1.device).repeat_interleave(H * W)
    d = torch.arange(-radius, radius + 2, device=fmap1.device,
                     dtype=torch.float32)
    out = torch.empty(N, len(pyramid) * kk, dtype=dt, device=fmap1.device)
    for lvl, f2 in enumerate(pyramid):
        hl, wl = f2.shape[1:3]
        f2f = f2.reshape(B * hl * wl, C)
        c = flat / float(2 ** lvl)
        c0 = torch.floor(c)
        frac = c - c0
        c0 = c0.clamp(-1e6, 1e6)
        for s in range(0, N, PLAIN_CHUNK):
            e = min(N, s + PLAIN_CHUNK)
            xs = c0[s:e, 0, None] + d                      # [n, k+1]
            ys = c0[s:e, 1, None] + d
            vx = (xs >= 0) & (xs <= wl - 1)
            vy = (ys >= 0) & (ys <= hl - 1)
            xi = xs.clamp(0, wl - 1).long()
            yi = ys.clamp(0, hl - 1).long()
            idx = (bidx[s:e, None, None] * (hl * wl)
                   + yi[:, :, None] * wl + xi[:, None, :])  # [n, y, x]
            g = f2f[idx.reshape(-1)].float().reshape(e - s, k + 1, k + 1, C)
            corner = torch.einsum("nc,nyxc->nyx", f1[s:e], g)
            corner = corner * (vy[:, :, None] & vx[:, None, :])
            dx = corner.transpose(1, 2)                    # [n, x, y]
            fx = frac[s:e, 0, None, None]
            fy = frac[s:e, 1, None, None]
            taps = ((1 - fx) * (1 - fy) * dx[:, :k, :k]
                    + fx * (1 - fy) * dx[:, 1:, :k]
                    + (1 - fx) * fy * dx[:, :k, 1:]
                    + fx * fy * dx[:, 1:, 1:])             # [n, dx, dy]
            out[s:e, lvl * kk:(lvl + 1) * kk] = taps.reshape(e - s, kk).to(dt)
    return out.reshape(B, H, W, len(pyramid) * kk)


@functools.cache
def _kernel():
    fn = load_cuda_library("corr_fused").corr_fused_lookup
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    return fn


def _check(fmap1, pyramid, coords, radius):
    if not fmap1.is_cuda:
        raise RuntimeError("lookup_corr_fused: CUDA tensors expected")
    dt = pyramid[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"lookup_corr_fused: unsupported dtype {dt}")
    B, H, W, C = fmap1.shape
    vec = 16 // pyramid[0].element_size()
    if C % (8 * vec) or C // (8 * vec) not in (1, 2, 4, 8):
        raise ValueError(f"lookup_corr_fused: C={C} must be 8*{vec}*(1|2|4|8)")
    if not 0 < len(pyramid) <= MAX_LEVELS or not 0 <= radius <= MAX_RADIUS:
        raise ValueError("lookup_corr_fused: levels/radius out of range")
    for lv in pyramid:
        if (lv.dtype != dt or lv.device != fmap1.device or lv.dim() != 4
                or lv.shape[0] != B or lv.shape[3] != C
                or not lv.is_contiguous() or lv.data_ptr() % 16):
            raise ValueError("lookup_corr_fused: pyramid levels must be "
                             "contiguous [B, H_l, W_l, C] of one dtype")
    if coords.shape != (B, H, W, 2):
        raise ValueError(f"lookup_corr_fused: coords {tuple(coords.shape)}")


def lookup_corr_fused(fmap1: torch.Tensor, pyramid: list,
                      coords: torch.Tensor, radius: int) -> torch.Tensor:
    """fmap1: [B, H, W, C]; pyramid: :func:`build_fmap_pyramid` levels;
    coords: [B, H, W, 2] level-0 (x, y). Returns [B, H, W, L·(2r+1)²] in
    the pyramid dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if fmap1.device.type == "cpu":
        return lookup_corr_plain(fmap1, pyramid, coords, radius)
    _check(fmap1, pyramid, coords, radius)
    dt = pyramid[0].dtype
    B, H, W, C = fmap1.shape
    k = 2 * radius + 1
    f1 = fmap1.to(dt).contiguous()
    cxy = coords.float().contiguous()
    out = torch.empty(B, H, W, len(pyramid) * k * k, dtype=dt,
                      device=fmap1.device)
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[lv.data_ptr() for lv in pyramid])
    dims = (ctypes.c_int * (2 * MAX_LEVELS))(
        *[s for lv in pyramid for s in lv.shape[1:3]])
    err = _kernel()(f1.data_ptr(), ptrs, dims, len(pyramid),
                    cxy.data_ptr(), out.data_ptr(), B * H * W, H * W, C,
                    radius, _DTYPE_CODE[dt],
                    torch.cuda.current_stream(fmap1.device).cuda_stream)
    check_launch(err, "corr_fused_lookup")
    lookup_corr_fused.launches += 1
    return out


lookup_corr_fused.launches = 0
