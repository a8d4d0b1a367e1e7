#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fgt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):
  1. print the card's name and power limit; build the CUDA kernels
     (one nvcc per source, all at once) and the host flowNN library;
  2. kernel K1 (RAFT corner-dot correlation) against its plain PyTorch
     version at the main-path shape, in f32 and bf16;
  3. kernel K2 (flash attention) against its plain version at
     N=80, L=2340, ch=128, in f32 and bf16; F.scaled_dot_product_attention
     is timed beside it as a yardstick only;
  4. the object-removal main path at full model width (random weights
     from seed 0, bf16): 24 synthetic panning frames at 432x240 with a
     moving 56x56 hole, run twice (cold, then warm); per pass the
     synchronized per-stage seconds, frames/s, peak memory and the
     kernels' launch counts (reset before the pass, read after it), which
     must all be > 0; output checked to be [24, 240, 432, 3] u8 and
     byte-identical to the input outside the hole;
  5. a small input through the port on the card and on the CPU (plain
     versions), which must agree;
  6. one JSON line with every kernel's numbers, then the result line.

Needs torch with CUDA, nvcc and g++; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12       # dense tensor-core peak
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def phase_k1(dtype, stats: dict):
    """K1 at the main-path shape: 46 pairs x 60x108 pixels, C=256, r=4,
    4 levels (60x108, 30x54, 15x27, 7x13 — odd sizes floor-pooled)."""
    import torch
    from fgt_tpu_torch.ops import corr_fused as cf

    g = torch.Generator(device="cuda").manual_seed(1)
    B, H, W, C, r, L = 46, 60, 108, 256, 4, 4
    f1 = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    f2 = torch.randn(B, H, W, C, device="cuda", generator=g)
    pyr = cf.build_fmap_pyramid(f2, L, dtype=dtype)
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda"),
                            torch.arange(W, device="cuda"), indexing="ij")
    coords = torch.stack([xs, ys], -1).float()[None].repeat(B, 1, 1, 1)
    coords = coords + 8 * torch.randn(B, H, W, 2, device="cuda", generator=g)
    coords[:, :4] = 1e4                       # far out of range: zero taps
    coords[:, 4:8] = -3e3
    got = cf.lookup_corr_fused(f1, pyr, coords, r)
    want = cf.lookup_corr_plain(f1, pyr, coords, r)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    # f32: reassociation of 256-term dots only; bf16 output: the two f32
    # sums may round to neighbouring bf16 values (1 ulp of the largest tap)
    tol = 1e-4 * max(1.0, top) if dtype == torch.float32 else top * 2 ** -7
    far = got[:, :8].float().abs().max().item()
    log(f"K1 {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol:.3g}, "
        f"max |tap| {top:.3g}); far-coord taps max {far}")
    if not err <= tol or far != 0.0:
        raise AssertionError("K1 disagrees with its plain version")
    kernel_ms = cuda_ms(lambda: cf.lookup_corr_fused(f1, pyr, coords, r), 20)
    plain_ms = cuda_ms(lambda: cf.lookup_corr_plain(f1, pyr, coords, r), 2)
    # work this run's data needs: in-bounds corner dots of every level
    valid = 0
    for lvl, lv in enumerate(pyr):
        c0 = torch.floor(coords / 2 ** lvl).clamp(-1e6, 1e6)
        d = torch.arange(-r, r + 2, device="cuda")
        vx = ((c0[..., :1] + d >= 0) & (c0[..., :1] + d <= lv.shape[2] - 1))
        vy = ((c0[..., 1:] + d >= 0) & (c0[..., 1:] + d <= lv.shape[1] - 1))
        valid += (vx.sum(-1) * vy.sum(-1)).sum().item()
    item = f1.element_size()
    nbytes = (f1.numel() * item + sum(lv.numel() for lv in pyr) * item
              + coords.numel() * 4 + got.numel() * item)
    flops = 2 * C * valid + 7 * got.numel()
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS if dtype ==
                       torch.bfloat16 else H100_F32_FLOPS)
    log(f"K1 {str(dtype)[6:]}: kernel_ms {kernel_ms:.4f} plain_ms "
        f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}; {nbytes / 1e9:.3f} GB, "
        f"{flops / 1e9:.2f} GFLOP)")
    stats[str(dtype)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=err, library_ms=None)


def phase_k2(dtype, stats: dict):
    """K2 at the main-path shape: 5 windows x 4 groups x 4 heads = 80
    sequences of 13 frames x 10 x 18 = 2340 tokens, head dim 128."""
    import torch
    import torch.nn.functional as F
    from fgt_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(2)
    n, l, ch = 80, 2340, 128
    q, k, v = (torch.randn(n, l, ch, device="cuda", generator=g).to(dtype)
               for _ in range(3))
    scale = ch ** -0.5
    out, lse = fa.flash_mhsa(q, k, v, scale)
    want, want_lse = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    top = want.float().abs().max().item()
    # f32: online vs one-shot softmax reassociation; bf16 output: 1 ulp
    tol = 2e-5 if dtype == torch.float32 else top * 2 ** -7
    log(f"K2 {str(dtype)[6:]}: max_abs_err {err:.3g} (tol {tol:.3g}), "
        f"lse err {err_lse:.3g} (tol 1e-4)")
    if not (err <= tol and err_lse <= 1e-4):
        raise AssertionError("K2 disagrees with its plain version")
    kernel_ms = cuda_ms(lambda: fa.flash_mhsa(q, k, v, scale), 5)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale), 3)
    # [1, N, L, ch]: batch 1 and N heads, the layout SDPA's fused paths take
    q4, k4, v4 = q[None], k[None], v[None]
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4), 5)
    item = q.element_size()
    nbytes = 4 * n * l * ch * item + n * l * 4
    flops = 4.0 * n * l * l * ch
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS if dtype ==
                       torch.bfloat16 else H100_F32_FLOPS)
    log(f"K2 {str(dtype)[6:]}: kernel_ms {kernel_ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by})")
    stats[str(dtype)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=err,
                             library_ms=library_ms)


def synthetic_video(n=24, h=240, w=432, hole=56, y0=90, x0=160, pan=2,
                    seed=0):
    """bench.py's data: a smoothed-noise background panning 2 px/frame and
    a square hole at (y0, x0) moving with it (uniform_filter in place of
    cv2)."""
    import scipy.ndimage

    rng = np.random.RandomState(seed)
    base = (rng.rand(h + 8, w + pan * n + 8, 3) * 255).astype(np.uint8)
    base = scipy.ndimage.uniform_filter(base.astype(np.float32),
                                        size=(9, 9, 1), mode="mirror")
    base = base.astype(np.uint8)
    frames = np.stack([base[4:4 + h, 4 + pan * i:4 + pan * i + w]
                       for i in range(n)])
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        masks[i, y0:y0 + hole, x0 + pan * i:x0 + pan * i + hole] = 1
    return frames, masks


def phase_main_path(counters):
    import torch
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    frames, masks = synthetic_video()
    t0 = time.perf_counter()
    models = vi.Models("cuda", bf16=True, seed=0)
    torch.cuda.synchronize()
    log(f"main path: models built in {time.perf_counter() - t0:.2f} s")
    launches = {}
    for label in ("cold", "warm"):   # the cold pass pays first-call costs
        torch.cuda.reset_peak_memory_stats()
        timer = vi.StageTimer("cuda")
        for c in counters:
            c.launches = 0
        out = vi.inpaint(frames, masks, models, timer=timer)
        launches = {c.__name__: c.launches for c in counters}
        total = sum(timer.times.values())
        log(f"main path {label} stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in timer.times.items()}))
        log(f"main path {label}: {len(frames)} frames in {total:.3f} s = "
            f"{len(frames) / total:.3f} frames/s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"launches {launches}")
        if out.shape != (24, 240, 432, 3) or out.dtype != np.uint8:
            raise AssertionError(f"output {out.shape} {out.dtype}")
        keep = masks == 0
        if not np.array_equal(out[keep], frames[keep]):
            raise AssertionError("output differs from the input outside "
                                 "the hole")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel was not launched: {launches}")
    hole_mean = out[masks > 0].astype(np.float64).mean()
    log(f"main path: output ok; mean value inside the hole {hole_mean:.2f}")
    return launches


def phase_small_reference():
    """6 frames at 64x64, full-width RAFT and LAFC, FGT at 512 hidden /
    4 heads (head dim 128 for K2) with 2 blocks, f32: the port on the card
    (kernels) against the port on the CPU (plain versions). Outside the
    hole the bytes must match; inside, flowNN's thresholded decisions can
    amplify f32 reassociation, so the bound is on the mean."""
    import torch
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    fgt_cfg = dict(vi.DEFAULT_FGT_CONFIG, numBlocks=2, mlp_ratio=4,
                   res_h=64, res_w=64)
    frames, masks = synthetic_video(n=6, h=64, w=64, hole=16, y0=24, x0=16)
    outs = []
    for dev in ("cuda", "cpu"):
        models = vi.Models(dev, bf16=False, raft_iters=4, fgt_config=fgt_cfg,
                           seed=3)
        outs.append(vi.inpaint(frames, masks, models, flow_mask_dilates=2,
                               neighbor_stride=3, step=4))
    gpu, cpu = (o.astype(np.int64) for o in outs)
    hole = masks > 0
    d = np.abs(gpu - cpu)[hole]
    log(f"small reference: card vs CPU inside the hole: mean |diff| "
        f"{d.mean():.4f}, max {d.max()}, share > 8 levels "
        f"{(d > 8).mean():.4f}")
    if not np.array_equal(gpu[~hole], cpu[~hole]) or d.mean() > 1.0:
        raise AssertionError("card and CPU runs of the port disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fgt_tpu_torch import native
    from fgt_tpu_torch.ops import _build, corr_fused, flash_attention

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    secs = _build.build_cuda_kernels()
    t0 = time.perf_counter()
    native._load()
    log(f"build: CUDA kernels {secs:.2f} s, host flowNN library "
        f"{time.perf_counter() - t0:.2f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1, k2 = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        phase_k1(dt, k1)
        phase_k2(dt, k2)
    counters = (corr_fused.lookup_corr_fused, flash_attention.flash_mhsa)
    launches = phase_main_path(counters)
    phase_small_reference()

    bf16 = str(torch.bfloat16)
    kernels = [
        dict(name="corr_fused_lookup", route="cuda",
             source="fgt_tpu_torch/csrc/corr_fused.cu",
             replaces="fgt_tpu/ops/corr_fused_pallas.py:65",
             launches=launches["lookup_corr_fused"], **k1[bf16]),
        dict(name="flash_attention_forward", route="cuda",
             source="fgt_tpu_torch/csrc/flash_attention.cu",
             replaces="fgt_tpu/ops/flash_attention.py:33",
             launches=launches["flash_mhsa"], **k2[bf16]),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
