"""RAFT all-pairs correlation pyramid and its lookup — kernel K3.

Replaces the TPU kernel ``fgt_tpu/ops/corr_lookup_pallas.py::_lookup_kernel``
(called per level through ``lookup_level_pallas`` by
``lookup_corr_pyramid_pallas``). This is the reference ``CorrBlock``
contract (RAFT/corr.py:12-50):

* :func:`build_corr_pyramid`, once per refine call: corr = f1·f2ᵀ/√C for
  every pixel pair, then ``avg_pool2d(2, 2)`` (floor on odd sizes) in
  f32, each level stored as ``[N, H_l, W_l]`` in the storage dtype;
* the lookup, every GRU iteration: for pixel n and level l, the k×k
  bilinear taps of ``vol_l[n]`` at ``(cx/2^l + dx, cy/2^l + dy)``, zero
  outside the level (grid_sample zero padding), dx on the slow axis and
  dy on the fast one (the reference quirk), ``[B, H, W, L·k²]`` f32 out.

The product. The JAX package upcasts the features and pools the f32
einsum (``fgt_tpu/models/raft.py:190-238``); a bf16 matmul would round
the product to bf16 before pooling. Here bf16 features are upcast to f32
and multiplied with TF32 tensor cores allowed: TF32 keeps 10 mantissa
bits, so bf16-valued inputs pass unrounded, every product is exact and
the sums are f32 — an f32 product at the tensor-core rate. f32 features
(``--f32``) take the full-f32 product.

Design of K3 for Hopper (``csrc/corr_lookup.cu``). The TPU kernel
streams each pixel's whole map through VMEM and contracts it with
one-hot matrices on the MXU; at the main-path shape that moves 5.5 GB per
GRU iteration. A bilinear lookup needs only the clipped (k+1)² window of
each level. Bytes bound it: at 46 pairs × 60×108 pixels, 4 bf16 levels,
r = 4, one iteration needs ≈0.15 GB of in-level window cells, the coords
and the taps — ≈0.54 GB with f32 taps (0.160 ms at 3.35 TB/s), ≈0.35 GB
with bf16 taps (≈0.10 ms). The window rows (20 B in bf16) start at any
element, so the 32-byte sectors they touch (~1.6 a row) make a floor of
the layout's own: on ``chip_smoke.py``'s data 0.40 GB of window sectors
(1.3 KB a pixel; 2.0 KB when every window lies inside its level), 0.23 ms
with f32 taps and 0.18 ms with bf16 taps.

The kernel (redesigned after a body with a warp per pixel that
gathered one level's window with 2-byte loads, then computed, then went
on to the next level): persistent warps walk over pixels, each with a
two-pixel ring in shared memory, so all levels' windows of the next pixel
are in flight as 16-byte ``cp.async`` copies of the aligned lines that
hold each window row while the current pixel's taps are computed; lines
outside the level are zero-filled by the copy, columns outside it masked
when the taps read them, so the pyramid needs no padding. The radius is a
template parameter (:data:`KERNEL_RADII`; any other radius raises), and
the taps come out in the caller's dtype: bf16 for the bf16 update block
(the f32 tap rounded once, as ``.to(torch.bfloat16)`` rounds it), f32
otherwise. Every product and sum is rounded on its own, y then x, so the
kernel equals its plain version bit for bit. ``lookup_corr_pyramid_warp``
launches that warp-per-pixel body, kept only as the yardstick
``chip_smoke.py`` times beside the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from fgt_tpu_torch.ops._build import check_launch, load_cuda_library

MAX_LEVELS = 6
KERNEL_RADII = (3, 4)            # the kernel's instantiations: RAFT's
PLAIN_CHUNK = 65536
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@contextlib.contextmanager
def _tf32_products():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _f32_product(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """[b, M, C] x [b, M, C] -> [b, M, M] f32 with exact products of the
    given features (see the module doc)."""
    exact_tf32 = f1.is_cuda and f1.dtype == torch.bfloat16
    a, b = f1.float(), f2.float().transpose(1, 2)
    if exact_tf32:
        with _tf32_products():
            return torch.matmul(a, b)
    return torch.matmul(a, b)


def pyramid_sizes(h: int, w: int, levels: int) -> list:
    sizes = [(h, w)]
    for _ in range(levels - 1):
        h, w = h // 2, w // 2
        sizes.append((h, w))
    return sizes


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       levels: int = 4, dtype: torch.dtype | None = None,
                       build_chunk: int = 8) -> list:
    """fmaps [B, H, W, C] -> list of ``levels`` volumes [B·H·W, H_l, W_l]
    in ``dtype`` (default f32). Pools in f32; builds ``build_chunk``
    pairs at a time so the f32 transient stays at
    build_chunk·(HW)²·4 bytes."""
    B, H, W, C = fmap1.shape
    dtype = dtype or torch.float32
    hw = H * W
    scale = torch.sqrt(torch.tensor(float(C), dtype=torch.float32))
    out = [torch.empty(B * hw, h, w, dtype=dtype, device=fmap1.device)
           for h, w in pyramid_sizes(H, W, levels)]
    for s in range(0, B, build_chunk):
        e = min(B, s + build_chunk)
        corr = _f32_product(fmap1[s:e].reshape(e - s, hw, C),
                            fmap2[s:e].reshape(e - s, hw, C))
        corr = corr.div_(scale.to(corr.device)).reshape((e - s) * hw, 1, H, W)
        for lvl, vol in enumerate(out):
            if lvl:
                corr = F.avg_pool2d(corr, 2, 2)
            vol[s * hw:e * hw] = corr[:, 0]
        del corr
    return out


def lookup_corr_pyramid_plain(pyramid: list, coords: torch.Tensor,
                              radius: int,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Plain PyTorch version of K3: gather each pixel's (k+1)² window per
    level (zero outside), then the bilinear taps, y then x, in f32.
    pyramid: [N, H_l, W_l] volumes; coords: [B, H, W, 2] level-0 (x, y).
    Returns [B, H, W, L·k²] f32 taps rounded once to ``out_dtype``. Pixels
    go in chunks of PLAIN_CHUNK."""
    B, H, W, _ = coords.shape
    N = B * H * W
    k = 2 * radius + 1
    kk = k * k
    dev = coords.device
    flat = coords.reshape(N, 2).float()
    d = torch.arange(-radius, radius + 2, device=dev)
    out = torch.empty(N, len(pyramid) * kk, dtype=torch.float32, device=dev)
    for lvl, vol in enumerate(pyramid):
        hl, wl = vol.shape[1:3]
        c = flat / float(2 ** lvl)
        c0 = torch.floor(c)
        frac = c - c0
        c0 = c0.clamp(-1e6, 1e6).long()
        for s in range(0, N, PLAIN_CHUNK):
            e = min(N, s + PLAIN_CHUNK)
            xs = c0[s:e, 0, None] + d                       # [n, k+1]
            ys = c0[s:e, 1, None] + d
            valid = (((ys >= 0) & (ys < hl))[:, :, None]
                     & ((xs >= 0) & (xs < wl))[:, None, :])
            idx = (torch.arange(s, e, device=dev)[:, None, None] * (hl * wl)
                   + ys.clamp(0, hl - 1)[:, :, None] * wl
                   + xs.clamp(0, wl - 1)[:, None, :])       # [n, y, x]
            win = vol.reshape(-1)[idx.reshape(-1)].float().reshape(idx.shape)
            win = torch.where(valid, win, torch.zeros_like(win))
            fx = frac[s:e, 0, None, None]
            fy = frac[s:e, 1, None, None]
            rows = (1 - fy) * win[:, :k] + fy * win[:, 1:]  # [n, dy, x]
            taps = (1 - fx) * rows[:, :, :k] + fx * rows[:, :, 1:]
            out[s:e, lvl * kk:(lvl + 1) * kk] = \
                taps.transpose(1, 2).reshape(e - s, kk)     # dx slow
    return out.reshape(B, H, W, len(pyramid) * kk).to(out_dtype)


def _bind(entry: str, out_dtype_arg: bool):
    fn = getattr(load_cuda_library("corr_lookup"), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_int] * out_dtype_arg + [ctypes.c_void_p])
    return fn


@functools.cache
def _kernel():
    return _bind("corr_lookup_pyramid", True)


@functools.cache
def _warp_kernel():
    return _bind("corr_lookup_pyramid_warp", False)


def _check(pyramid, coords, radius, out_dtype):
    if not coords.is_cuda:
        raise RuntimeError("lookup_corr_pyramid: CUDA tensors expected")
    dt = pyramid[0].dtype
    if dt not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"lookup_corr_pyramid: unsupported dtype {dt} -> "
                        f"{out_dtype}")
    if not 0 < len(pyramid) <= MAX_LEVELS or radius not in KERNEL_RADII:
        raise ValueError(f"lookup_corr_pyramid: {len(pyramid)} levels, "
                         f"radius {radius}: the kernel takes 1-{MAX_LEVELS} "
                         f"levels and radius {KERNEL_RADII}")
    if coords.dim() != 4 or coords.shape[3] != 2:
        raise ValueError(f"lookup_corr_pyramid: coords {tuple(coords.shape)}")
    n = coords.shape[0] * coords.shape[1] * coords.shape[2]
    for vol in pyramid:
        if (vol.dtype != dt or vol.device != coords.device or vol.dim() != 3
                or vol.shape[0] != n or not vol.is_contiguous()
                or vol.data_ptr() % 16):
            raise ValueError("lookup_corr_pyramid: levels must be contiguous, "
                             "16-byte aligned [B*H*W, H_l, W_l] of one dtype "
                             "on the card")


def _launch(fn, pyramid, coords, radius, out_dtype, *extra):
    B, H, W, _ = coords.shape
    k = 2 * radius + 1
    cxy = coords.float().contiguous()
    if cxy.data_ptr() % 8:                   # the kernel loads (x, y) pairs
        cxy = cxy.clone()
    out = torch.empty(B, H, W, len(pyramid) * k * k, dtype=out_dtype,
                      device=coords.device)
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[v.data_ptr() for v in pyramid])
    dims = (ctypes.c_int * (2 * MAX_LEVELS))(
        *[s for v in pyramid for s in v.shape[1:3]])
    err = fn(ptrs, dims, len(pyramid), cxy.data_ptr(), out.data_ptr(),
             B * H * W, radius, _DTYPE_CODE[pyramid[0].dtype], *extra,
             torch.cuda.current_stream(coords.device).cuda_stream)
    check_launch(err, fn.__name__)
    return out


def lookup_corr_pyramid(pyramid: list, coords: torch.Tensor, radius: int,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """pyramid: :func:`build_corr_pyramid` volumes; coords: [B, H, W, 2]
    level-0 (x, y). Returns [B, H, W, L·(2r+1)²] taps in ``out_dtype``
    (f32 or bf16, the f32 tap rounded once). CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if coords.device.type == "cpu":
        return lookup_corr_pyramid_plain(pyramid, coords, radius, out_dtype)
    _check(pyramid, coords, radius, out_dtype)
    out = _launch(_kernel(), pyramid, coords, radius, out_dtype,
                  _DTYPE_CODE[out_dtype])
    lookup_corr_pyramid.launches += 1
    return out


lookup_corr_pyramid.launches = 0


def lookup_corr_pyramid_warp(pyramid: list, coords: torch.Tensor,
                             radius: int) -> torch.Tensor:
    """K3's former body (a warp per pixel, one level at a time, f32
    taps) on CUDA tensors: the yardstick ``chip_smoke.py`` times beside
    :func:`lookup_corr_pyramid`. Nothing in the port calls it."""
    _check(pyramid, coords, radius, torch.float32)
    return _launch(_warp_kernel(), pyramid, coords, radius, torch.float32)
