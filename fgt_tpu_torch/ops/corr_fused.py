"""RAFT correlation lookup from pooled feature corners — kernel K1.

Replaces the TPU kernel ``fgt_tpu/ops/corr_fused_pallas.py::_fused_kernel``
(called through ``lookup_corr_fused``). Contract: for every pixel and
pyramid level l, the (2r+1)^2 bilinear taps of the level-l correlation
map at coords/2^l, with corr = f1·f2/√C, taps outside a level exactly
zero, floor pooling on odd sizes, output [B, H, W, L·k²] with dx slow and
dy fast within a level, in the feature dtype. In bf16 the pyramid holds a
bf16 level 0 and f32 coarser levels (:func:`build_fmap_pyramid`).

Design for Hopper (``csrc/corr_fused.cu``). The TPU kernel keeps a pair's
whole level-0 fmap2 (≈4 MB in bf16) in VMEM and builds a correlation slab
from it; an H100 block has 227 KB of shared memory, so that design does
not carry over. Average-pooling the correlation equals correlating with
average-pooled features (pooling is linear), so — the reference
AlternateCorrBlock contract — each level needs only the (k+1)² corner
dots of f1 with that level's pooled fmap2; all k² taps share one
bilinear fraction.

* bf16 (tensor cores). A pixel's corners are (k+1)² = 100 channel
  vectors a level, 205 KB over 4 levels at C = 256, and a warp per pixel
  (the f32 body below) reads all of them: ≈61 GB from L2 a launch at the
  main-path shape, so L2 bounds it, not HBM. Neighbouring pixels' windows
  overlap almost entirely where flow is smooth. So a block takes a tile
  of TILE×TILE pixels of one pair (f1's tile in shared memory) and, per
  level, the bounding box of the tile's windows clipped to the level. If
  the box holds at most BOX_CAP corners, the box's feature rows stream
  through a two-stage ring into swizzled shared memory (the next chunk's
  global loads in flight in registers), and ``mma.sync`` products
  [16 pixels × C]·[C × 16 corners] (f32 accumulation) are scattered into
  each pixel's own (k+1)² window dots, from which it combines its k²
  taps. Keeping only the windows (25 KB a block, not a [64 × box] score
  tile) puts two blocks on an SM. Level 0 is bf16; a coarser level is
  f32 and is split into bf16 hi + lo rows as it is staged
  (hi = bf16(x), lo = bf16(x − hi)), two products into one accumulator
  (≈2⁻¹⁷ relative, far below a bf16 tap's ulp). A tile whose box exceeds
  the cap (noisy or far-flung coords) takes the general route in the
  same kernel: a warp per pixel, as the f32 body. :func:`tile_routes`
  says which route each tile takes, and :func:`route_tiles` what the
  kernel counted.
* f32 (FMA units). One warp serves one pixel: f1 sits in registers
  pre-scaled by 1/√C, 8-lane groups each take one corner (16-byte
  coalesced loads of the channels-last corner vector, f32 accumulation,
  3 shuffles), the corner dots go to shared memory and the warp writes
  the 81 taps of the level.

Bound on the card: at the main-path shape (46 pairs × 60×108 pixels,
C = 256, bf16) one launch must move ≈0.6 GB (f1, the pyramid, coords,
taps) and do at most ≈61 GFLOP (less where corners fall outside a
level), so bytes bound it (≈0.18 ms at 3.35 TB/s).

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
TILE = 8          # bf16 body: a block's pixel tile is TILE x TILE
BOX_CAP = 1024    # bf16 body: most corners a tile's box route takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_routes: dict = {}  # device -> int64 [2]: tile-levels on (box, general)


def build_fmap_pyramid(fmap2: torch.Tensor, num_levels: int = 4,
                       dtype: torch.dtype | None = None) -> list:
    """Average-pooled FEATURE pyramid (floor on odd sizes, like
    ``avg_pool2d(2, 2)``): [B, H, W, C] -> list of [B, H_l, W_l, C]
    channels-last contiguous levels. Level 0 is fmap2 in ``dtype``
    (default: fmap2's); the coarser levels are pooled in f32 from that
    rounded level 0 and kept in f32. This is what the TPU kernel computes
    in bf16: it keeps only a bf16 level 0 and takes every coarser tap as
    the f32 mean of level-0 correlations (``fgt_tpu/ops/
    corr_fused_pallas.py``), so a coarser level rounded to bf16 would
    differ from it. In f32 every level is f32, as before."""
    lv0 = fmap2.to(dtype or fmap2.dtype).contiguous()
    levels = [lv0.float().permute(0, 3, 1, 2)]
    for _ in range(num_levels - 1):
        levels.append(F.avg_pool2d(levels[-1], 2, 2))
    return [lv0] + [lv.permute(0, 2, 3, 1).contiguous() for lv in levels[1:]]


def lookup_corr_plain(fmap1: torch.Tensor, pyramid: list,
                      coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch version of K1: gather the corner vectors, dot them
    with f1 in f32 (each level widened from its own dtype), combine the
    taps. Same inputs and output contract as :func:`lookup_corr_fused`:
    f1 is rounded to, and the taps returned in, level 0's dtype (the
    feature dtype). Pixels go in chunks of PLAIN_CHUNK to bound the
    gathered temporary."""
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


def tile_routes(coords: torch.Tensor, sizes: list, radius: int) -> dict:
    """The routes the bf16 kernel takes for ``coords`` ([B, H, W, 2]
    level-0 (x, y)) over levels of ``sizes`` [(H_l, W_l), ...]: the
    number of (tile, level) pairs whose clipped corner box holds at most
    BOX_CAP corners ("box", the tensor-core route; an empty box too) and
    of those whose box exceeds it ("general"). The same arithmetic as the
    kernel: a pixel whose window misses the level adds nothing to the
    box."""
    B, H, W, _ = coords.shape
    k = 2 * radius + 1
    th, tw = -(-H // TILE), -(-W // TILE)
    pad = (0, 0, 0, tw * TILE - W, 0, th * TILE - H)
    c = F.pad(coords.float(), pad)
    inside = F.pad(torch.ones(B, H, W, dtype=torch.bool,
                              device=coords.device), pad[2:])
    big = 1 << 30

    def tiles(t):  # [B, th*TILE, tw*TILE, 2] -> [B, th, tw, TILE*TILE, 2]
        t = t.reshape(B, th, TILE, tw, TILE, 2).transpose(2, 3)
        return t.reshape(B, th, tw, TILE * TILE, 2)

    routes = {"box": 0, "general": 0}
    for lvl, (hl, wl) in enumerate(sizes):
        lo = torch.floor(c / float(2 ** lvl)).clamp(-1e6, 1e6).long() - radius
        a = lo.clamp(min=0)
        b = torch.minimum(lo + k, torch.tensor([wl - 1, hl - 1],
                                               device=c.device))
        ok = (inside & (a <= b).all(-1))[..., None].expand(-1, -1, -1, 2)
        a0 = torch.where(tiles(ok), tiles(a), big).amin(3)
        b0 = torch.where(tiles(ok), tiles(b), -big).amax(3)
        n = (b0 - a0 + 1).clamp(min=0).prod(-1)
        routes["box"] += int((n <= BOX_CAP).sum())
        routes["general"] += int((n > BOX_CAP).sum())
    return routes


def _route_buffer(device: torch.device) -> torch.Tensor:
    buf = _routes.get(device)
    if buf is None:
        # a normal tensor even when the first launch runs under
        # inference mode, so reset_route_tiles() may zero it anywhere
        with torch.inference_mode(False):
            buf = _routes[device] = torch.zeros(2, dtype=torch.int64,
                                                device=device)
    return buf


def route_tiles() -> dict:
    """(tile, level) pairs that took the bf16 kernel's box route and its
    general route since :func:`reset_route_tiles`, summed over devices.
    The kernel counts them on the device, so a launch costs no host sync;
    reading them here syncs."""
    box, general = 0, 0
    for buf in _routes.values():
        b, g = buf.tolist()
        box, general = box + b, general + g
    return {"box": box, "general": general}


def reset_route_tiles() -> None:
    for buf in _routes.values():
        buf.zero_()


@functools.cache
def _kernel():
    fn = load_cuda_library("corr_fused").corr_fused_lookup
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _check(fmap1, pyramid, coords, radius):
    """Raise unless the operands fit a body: f32 (every level f32, C a
    multiple of 32) or bf16 (a bf16 level 0 and f32 coarser levels, C of
    64, 128 or 256)."""
    if not fmap1.is_cuda:
        raise RuntimeError("lookup_corr_fused: CUDA tensors expected")
    dt = pyramid[0].dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"lookup_corr_fused: unsupported dtype {dt}")
    B, H, W, C = fmap1.shape
    if dt == torch.float32:
        if C % 32 or C // 32 not in (1, 2, 4, 8):
            raise ValueError(f"lookup_corr_fused: C={C} must be 32*(1|2|4|8)")
    elif C not in (64, 128, 256):
        raise ValueError(f"lookup_corr_fused: C={C} must be 64, 128 or 256 "
                         "in bf16")
    if not 0 < len(pyramid) <= MAX_LEVELS or not 0 <= radius <= MAX_RADIUS:
        raise ValueError("lookup_corr_fused: levels/radius out of range")
    for lvl, lv in enumerate(pyramid):
        want = dt if lvl == 0 else torch.float32
        if (lv.dtype != want or lv.device != fmap1.device or lv.dim() != 4
                or lv.shape[0] != B or lv.shape[3] != C
                or not lv.is_contiguous() or lv.data_ptr() % 16):
            raise ValueError("lookup_corr_fused: pyramid levels must be "
                             "contiguous [B, H_l, W_l, C], level 0 in the "
                             "feature dtype and the others in f32")
    if coords.shape != (B, H, W, 2):
        raise ValueError(f"lookup_corr_fused: coords {tuple(coords.shape)}")


def lookup_corr_fused(fmap1: torch.Tensor, pyramid: list,
                      coords: torch.Tensor, radius: int) -> torch.Tensor:
    """fmap1: [B, H, W, C]; pyramid: :func:`build_fmap_pyramid` levels;
    coords: [B, H, W, 2] level-0 (x, y). Returns [B, H, W, L·(2r+1)²] in
    level 0's dtype. CPU tensors take the plain version; CUDA tensors
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
                    cxy.data_ptr(), out.data_ptr(), B, H, W, C, radius,
                    _DTYPE_CODE[dt], _route_buffer(fmap1.device).data_ptr(),
                    torch.cuda.current_stream(fmap1.device).cuda_stream)
    check_launch(err, "corr_fused_lookup")
    lookup_corr_fused.launches += 1
    return out


lookup_corr_fused.launches = 0
