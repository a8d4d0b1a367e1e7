#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``fgt_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits nonzero; nothing is caught):
  1. print the card's name and power limit; build the CUDA kernels
     (one nvcc per source, all at once), the host flowNN library and the
     host JPEG decoder; decode the committed JPEG fixtures
     (tests/data/jpeg: baseline, progressive from Pillow and cv2 with
     and without restarts, gray and 4:2:0, a progressive file left
     unrefined so that block smoothing runs, 4:1:1, CMYK, YCCK, a
     sequential file of three scans; arithmetic-coded SOF9 and SOF10
     files from libjpeg-turbo's encoder, DAC conditioning, an 854x480
     frame each way), which must equal cv2's decodes bit for bit (the
     PNG beside each, or for the 854x480 frames its SHA-256 in
     arith_decodes.json), and time an 854x480 4:2:0 decode, baseline,
     progressive (which must decode alike), arithmetic sequential and
     arithmetic progressive; print every kernel's
     registers, stack, static shared memory and spills (cuobjdump);
  2. kernel K1 (RAFT corner-dot correlation) against its plain PyTorch
     version at the main-path shape, in f32 and bf16 (bf16 level 0, f32
     coarser levels); in bf16 on noisy coords (the general route) and on
     a smooth flow (the box route), each timed, with the (tile, level)
     route counts, which must equal ``tile_routes``'; again in bf16 at
     RAFT small's shape (C = 128, r = 3); the f32 numbers are also the
     --alternate_corr contract's;
  3. kernel K2 (flash attention) against its plain version at
     N=80, L=2340, ch=128, in f32 and bf16; F.scaled_dot_product_attention
     is timed beside it as a yardstick only;
  4. kernels K4 (dq) and K5 (dk, dv), the flash backward, at training's
     N=32, L=900, ch=128, in f32 and bf16: against their plain versions
     and against autograd of the plain forward; SDPA's backward (forward
     + backward minus forward) is timed beside them as a yardstick only;
     K4's tensor-core body's registers, shared memory and spills;
  5. kernel K3 (RAFT all-pairs pyramid lookup) against its plain version
     at the main-path shape (one GRU iteration, 46 pairs x 60x108 pixels,
     4 levels), f32 and bf16 storage, f32 and bf16 taps, radius 4 and 3,
     with coords on, past and far outside the level edges (equal, bf16
     taps being the f32 taps rounded once); timed at radius 4 in both
     tap dtypes beside the warp-per-pixel body it replaced (kept in
     the source as the yardstick), its bound and its sector floor (the
     32-byte sectors of this run's window rows); F.grid_sample, one call
     per level, timed beside it as a yardstick only; then the all-pairs
     pyramid build of
     one refine (TF32 product of bf16 features against the f32 product);
     K3 at r = 3 on the bf16 pyramid of C = 128 features (RAFT small),
     equal to its plain version, timed beside grid_sample;
     then RAFT refine in bf16 on a 64x64 pair with K1 and with its plain
     version in its place, whose flows must agree;
  6. the object-removal main path at full model width (random weights
     from seed 0, bf16): 24 synthetic panning frames at 432x240 with a
     moving 56x56 hole, run twice (cold, then warm) on each s1 path, K1
     (default) and the all-pairs pyramid (K3); per pass the synchronized
     per-stage seconds, frames/s, peak memory and the kernels' launch
     counts (reset before the pass, read after it: 20 per video of the
     path's correlation kernel, none of the other's, K2 > 0; K1's route
     counts on the K1 path); output
     checked to be [24, 240, 432, 3] u8 and byte-identical to the input
     outside the hole; the two warm s1 times side by side;
  7. through the CLI at full width: watermark removal from PNG
     directories with premasked frames (default path), video
     extrapolation to a 1.2x canvas of 288x516 (pyramid path; the centre
     must be the input) and --Nonlocal on 12 frames (pyramid path);
     offline flow extraction of a PNG and a JPEG video x 8 frames (28
     .flo files, K3 160 launches); the batch driver over a PNG and a
     JPEG video (every row ok);
  8. stage-1 training at the full width of configs/lafc_train.yaml
     (LAFC: batch 4 x 3 flows at 256x256, cnum 48, resBlocks 1, bf16,
     the global-norm clip) and configs/lafc_single_train.yaml
     (LAFC-single: batch 4 at 256x256, 4-D items) through
     ``LAFCTrainer``, on a batch made on the card (smooth flows with
     moving blocks, moving holes, diffused flows from ``ops/diffusion``,
     Canny edges from ``core/edge``, a frame pair warped by the flow):
     2 cold steps, then 10 timed steps (steps/s, peak memory, TFLOP of
     convolutions a step, the card's name and power limit); every loss
     term finite, the total falling; a resume check under deterministic
     algorithms (bit-equal losses and weights); no launch of K1-K5. The
     LAFC trainer's ``latest`` directory is then ``--lafc_ckpts`` of a
     6-frame object-removal run (20 K1 launches), and the LAFC-single
     trainer's checkpoint is stage 2's flow oracle:
     FGT stage-2 GAN training at the full width of
     configs/fgt_train.yaml (240x432, 5 frames, batch 2, 512 hidden,
     8 blocks, mixed precision: bf16 parameter copies, as the JAX step)
     through ``FGTTrainer``, with that frozen LAFC-single oracle: 2 cold
     steps, then 10 timed steps (steps/s, peak memory,
     K2/K4/K5 launches per step, which must be 4 each); losses finite,
     l1 falling, every TMHSA q/k/v embedding weight with a finite nonzero
     gradient; then a resume check (save the trio, 3 steps, reload,
     3 steps: gen_loss must match);
     then RAFT --small through the CLI, cold and warm on both s1 paths
     (K1 at C = 128, r = 3, 20 launches, or K3 at r = 3, 20 launches),
     --alternate_corr with --fused_corr off (20 launches of K1's f32
     body, no K3), the evaluation driver over 2 PNG videos x 24 frames
     with a random-init I3D for VFID (every number finite, eval.json;
     I3D features of a clip on the card against the CPU's) and one
     6-frame run with every debug flag (--vis_*, --profile, an --opt
     YAML that sets 3 GRU iterations); object removal from a
     DAVIS-style JPEG clip (24 frames at 854x480, baseline 4:2:0, PNG
     masks, written by the tests' numpy encoder) at 432x240: the default
     run, --exact_windows (one FGT forward per window of 8, 12, 13, 12
     and 11 frames: 20 K2 launches, each window's K2 shape then held
     against its plain version in f32 and bf16 and timed) and
     --host_diffusion (s2 on the host's multigrid solve), s6 and s2
     seconds side by side;
     then dataset preparation (``phase_dataset_prep``): a 24-frame
     432x240 folder written by the port's tools (frames through
     ``data/readers.save_frames_to_dir``, moving-stroke masks of
     ``core/masks`` saved by ``MaskReader``, their ``get_bboxes`` boxes
     rasterised by ``MaskGenerator``), read back equal, and object
     removal through the CLI on both mask folders (output [24, 240, 432,
     3] u8, byte-identical to the input outside the hole, K1 20 and K2 4
     launches each; frames/s and peak memory beside phase 6's warm
     pass); the stroke run's result written as an MJPG AVI
     (``FrameReader.write_files_to_video``) and read back by
     ``core/video_io.read_video``: 24 frames at >= 36 dB PSNR;
     then training from disk through the training CLI
     (``fgt_tpu_torch.train.train.main``): a YouTube-VOS-style tree (4
     videos x 10 PNG frames at 480x864, .flo flows at 240x432: smooth
     fields with blocks moving against them) and a DAVIS-style
     validation tree (2 videos x 24 frames, flows and masks, at
     240x432), both from a seed; copies of configs/lafc_single_train,
     lafc_train and fgt_train.yaml with only the data paths, MAX_ITERS,
     val_freq, log_freq, a valInfo block and FGT's flow_checkPoint (the
     LAFC-single run's latest/model.pth) replaced, read and written by
     the port's YAML reader; each run 2 cold + 10 timed steps with
     --use_valid and the committed n_workers (4): steps/s through the
     loader, the loader's own items/s with 4 workers and with 0, the
     validation scores, peak memory; every loss term finite, val/psnr,
     ssim, l1, l2 finite in metrics.jsonl, no kernel launch in either
     stage-1 run, 4 launches a step of K2, K4 and K5 in FGT training and
     K2's launches inside validate_fgt equal to 2 videos x its temporal
     blocks; the on-card-batch rates are printed beside them; the same
     phase again from a JPEG tree (the same pixels as baseline 4:2:0
     JPEG), its rates beside the PNG tree's; then the sustained-training
     tool (``fgt_tpu_torch.tools.sustained_train.main``, the JAX tool's
     protocol: 240x432, 5 frames, batch 2, bf16, the committed model
     scale, 4 videos x 12 JPEG frames, 4 loader workers, 48 steps,
     validation every 16):
     the LR decayed mid-run, two validations with finite val/*, every
     loss finite, the checkpoint trio, K2 4 a step plus 4 videos x its
     temporal blocks a validation, K4 and K5 4 a step; then data parallelism:
     the PNG phase again with each CLI run in a one-rank NCCL group
     (``--coordinator 127.0.0.1:<free port> --num_processes 1
     --process_id 0``, the group checked at every step), its steps/s
     beside the run without a group; and each committed config (f32)
     trained by two gloo ranks sharing cuda:0
     (``tests/torch_port_dp_worker.py``, 12 steps on halves of 3 global
     batches) against one process on the whole batches and against one
     process on the batches with their halves swapped (the reference
     spread): metrics and the trained models' outputs within the stated
     floors or twice that spread, the replicas bit-equal, K2/K4/K5 4 a
     FGT step on each rank; then tensor and sequence parallelism on two
     gloo ranks sharing cuda:0 (``tests/torch_port_parallel_worker.py``,
     cuDNN deterministic): object removal at full width under --tp 2,
     --sp 2 and --dp --window_batch 4, in f32 and bf16, against one
     process (f32 within 1 u8 level and equal to the input outside the
     hole, bf16 within twice one process's own bf16-vs-f32 deviation,
     the ranks equal, K1 and K2 launches and K2's N a rank asserted), and
     configs/fgt_train.yaml (f32) under tp 2 and sp 2 against one process
     (the data-parallel rule; replicated leaves and the discriminator
     bit-equal; K2/K4/K5 4 a step at N 16 a rank), printing per-rank
     parameter bytes, tp_param_fraction, peak memory and the time-sliced
     rates beside one process's; then the overfit quality gate's two
     protocols at full size (``fgt_tpu_torch.tools.overfit_gate``, under
     PyTorch's default TF32): each must raise its PSNR, with K1 40, K2
     408, K4 and K5 400 launches a protocol;
     then the conv-block library (``phase_conv_types``): gated LAFC and
     FGT under norm None, BN, IN and SN at phase 9's small size, card
     against CPU; gated BN object removal at full width (LAFC cnum 48,
     FGT 512 hidden / 8 blocks / 4 heads, bf16, the K1 path) from
     JAX-layout ``.msgpack`` directories the port writes from seeded
     weights and reads back strictly, cold then warm (output shape and
     bytes outside the hole, K1 20 and K2 4), its warm stage seconds and
     frames/s beside phase 6's vanilla warm pass; 6 steps each of gated
     configs/lafc_single_train.yaml and lafc_train.yaml, then 6 GAN steps
     of configs/fgt_train.yaml gated under norm SN and again under BN on
     the gated LAFC-single's checkpoint (losses finite, K2/K4/K5 4 a
     step, the decoder's BN statistics moved, SN's u and v unchanged),
     steps/s beside this run's vanilla rates;
  9. small inputs through the port on the card and on the CPU (plain
     versions), which must agree: object-removal runs on the K1 path, on
     the pyramid path with --Nonlocal and with RAFT --small, one SGD
     GAN step and one SGD LAFC step (losses and parameter deltas);
 10. one JSON line with every kernel's numbers, then the result line.

``--profile`` adds a torch.profiler trace of two training steps after
phase 8 and prints the device time by kernel.

Needs torch with CUDA, nvcc and g++; imports nothing of JAX (the JPEG
trees are written by the port's ``core/jpeg_encode``, the progressive
frame by ``tests/torch_port_jpeg_encoder.py``'s scan writer, numpy only).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
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


def kernel_events(prof) -> list:
    """The device kernels of a torch.profiler trace (key averages),
    without user-annotation ranges."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_ms(fn, reps: int) -> float:
    """Device time of the kernels ``fn`` launches, per call, from a
    torch.profiler trace: unlike events around a loop, it does not count
    the gaps where the card waits for a host-bound caller."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in kernel_events(prof)) / 1e3 / reps


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def resource_usage() -> dict:
    """Registers, stack, static shared memory and local (spill) bytes of
    every kernel in the built libraries, as cuobjdump reports them
    (dynamic shared memory is set at launch, from the sources'
    constants). Returns {kernel label: usage}."""
    import re
    from fgt_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("resources: cuobjdump not found")
        return {}
    names = {"f": "f32", "13__nv_bfloat16": "bf16"}
    found = {}
    for name, source in _build.CUDA_SOURCES.items():
        lib = _build._target(name, os.path.join(_build.CSRC_DIR, source),
                             [nvcc] + _build.NVCC_FLAGS)
        dump = subprocess.run([cuobjdump, "--dump-resource-usage", lib],
                              capture_output=True, text=True).stdout
        for fn, usage in re.findall(r"Function (\S+):\s*\n\s*(REG:[^\n]*)",
                                    dump):
            kernel = re.search(r"(flash_(fwd|dq|dkv)|corr_fused|corr_lookup)"
                               r"(_bf16|_warp)?_kernel", fn).group(0)
            args = re.search(
                kernel + r"I((?:f|13__nv_bfloat16|S1_|Li\d+E)+)E", fn)
            if args:  # template arguments: types (S1_ repeats one) and ints
                kernel += "<" + ",".join(
                    names.get(t or n, n) for n, t in re.findall(
                        r"Li(\d+)E|(f|13__nv_bfloat16)",
                        args.group(1).replace("S1_", "13__nv_bfloat16"))) + ">"
            found[kernel] = " ".join(usage.split()[:4])
            log(f"resources {kernel}: {found[kernel]}")
    return found


def smooth_coords(b, h, w, gen, nodes=(4, 7), amp=8.0):
    """The pixel grid plus a smooth random flow: a low-resolution field
    of ``amp`` px, bilinearly upsampled. [b, h, w, 2] f32 (x, y) on the
    generator's device."""
    import torch
    import torch.nn.functional as F

    dev = gen.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    grid = torch.stack([xs, ys], -1).float()[None].repeat(b, 1, 1, 1)
    field = amp * torch.randn(b, 2, *nodes, device=dev, generator=gen)
    flow = F.interpolate(field, size=(h, w), mode="bilinear",
                         align_corners=True)
    return grid + flow.permute(0, 2, 3, 1)


def k1_bound(f1, pyr, coords, out, r: int, dtype):
    """K1's bound on this run's inputs: each input byte read once at its
    own element size (in bf16 level 0 is bf16, the coarser levels f32),
    the taps written once; the in-bounds corner dots of every level."""
    import torch

    valid = 0
    for lvl, lv in enumerate(pyr):
        c0 = torch.floor(coords / 2 ** lvl).clamp(-1e6, 1e6)
        d = torch.arange(-r, r + 2, device="cuda")
        vx = ((c0[..., :1] + d >= 0) & (c0[..., :1] + d <= lv.shape[2] - 1))
        vy = ((c0[..., 1:] + d >= 0) & (c0[..., 1:] + d <= lv.shape[1] - 1))
        valid += (vx.sum(-1) * vy.sum(-1)).sum().item()
    nbytes = (f1.numel() * f1.element_size()
              + sum(lv.numel() * lv.element_size() for lv in pyr)
              + coords.numel() * 4 + out.numel() * out.element_size())
    flops = 2 * f1.shape[-1] * valid + 7 * out.numel()
    return nbytes, flops, bound(nbytes, flops, H100_BF16_FLOPS if dtype ==
                                torch.bfloat16 else H100_F32_FLOPS)


def phase_k1(dtype, stats: dict, C: int = 256, r: int = 4):
    """K1 at the main-path shape: 46 pairs x 60x108 pixels, C=256, r=4,
    4 levels (60x108, 30x54, 15x27, 7x13 — odd sizes floor-pooled), or at
    RAFT small's (C=128, r=3). Coords
    are the pixel grid plus 8 px of noise per pixel (in bf16, level 0's
    tile boxes overflow: the general route) with far-out-of-range rows;
    in bf16 also a smooth flow (a 4x7 field of 8 px, upsampled: the box
    route), both timed, with the routes each took. Stats go under
    ``stats[str(dtype)]`` at the main-path shape, under
    ``stats[f"{dtype} C{C} r{r}"]`` at another."""
    import torch
    from fgt_tpu_torch.ops import corr_fused as cf

    g = torch.Generator(device="cuda").manual_seed(1 + C + r)
    B, H, W, L = 46, 60, 108, 4
    key = str(dtype) if (C, r) == (256, 4) else f"{dtype} C{C} r{r}"
    f1 = torch.randn(B, H, W, C, device="cuda", generator=g).to(dtype)
    f2 = torch.randn(B, H, W, C, device="cuda", generator=g)
    pyr = cf.build_fmap_pyramid(f2, L, dtype=dtype)
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda"),
                            torch.arange(W, device="cuda"), indexing="ij")
    coords = torch.stack([xs, ys], -1).float()[None].repeat(B, 1, 1, 1)
    coords = coords + 8 * torch.randn(B, H, W, 2, device="cuda", generator=g)
    coords[:, :4] = 1e4                       # far out of range: zero taps
    coords[:, 4:8] = -3e3
    inputs = [("noisy", coords, 8)]           # (label, coords, far rows)
    if dtype == torch.bfloat16:
        smooth = smooth_coords(B, H, W, g)
        smooth[:, :2] = 1e4
        inputs.append(("smooth", smooth, 2))
    name = str(dtype)[6:] + ("" if (C, r) == (256, 4) else f" C={C} r={r}")
    if dtype == torch.bfloat16 and (C, r) == (256, 4):
        # the K1 path's memory: the pyramid of bf16 features (as RAFT's
        # bf16 encoder hands them over) and one lookup, above the features
        f2b = f2.to(dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pyr_b = cf.build_fmap_pyramid(f2b, L, dtype=dtype)
        taps = cf.lookup_corr_fused(f1, pyr_b, coords, r)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        stored = [lv.numel() * lv.element_size() / 1e9 for lv in pyr_b]
        log(f"K1 {name} pyramid: levels stored {sum(stored):.4f} GB (level 0 "
            f"{stored[0]:.4f} GB bf16, levels 1-{L - 1} {sum(stored[1:]):.4f} "
            f"GB f32); build + one lookup peak {peak:.4f} GiB above the "
            f"features")
        del f2b, pyr_b, taps
    for label, cxy, far_rows in inputs:
        cf.reset_route_tiles()
        got = cf.lookup_corr_fused(f1, pyr, cxy, r)
        routes = cf.route_tiles()
        want = cf.lookup_corr_plain(f1, pyr, cxy, r)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        # f32: reassociation of 256-term dots only; bf16 output: the two
        # f32 sums may round to neighbouring bf16 values (1 ulp of the
        # largest tap)
        tol = 1e-4 * max(1.0, top) if dtype == torch.float32 else \
            top * 2 ** -7
        far = got[:, :far_rows].float().abs().max().item()
        log(f"K1 {name} ({label} coords): max_abs_err {err:.3g} (tol "
            f"{tol:.3g}, max |tap| {top:.3g}); far-coord taps max {far}")
        if not err <= tol or far != 0.0:
            raise AssertionError("K1 disagrees with its plain version")
        if dtype == torch.bfloat16:
            sizes = [lv.shape[1:3] for lv in pyr]
            if routes != cf.tile_routes(cxy, sizes, r):
                raise AssertionError(f"K1 route counts {routes} differ from "
                                     "tile_routes'")
            share = routes["box"] / max(1, sum(routes.values()))
            log(f"K1 {name} ({label} coords): routes of the (tile, level) "
                f"pairs {routes}, box share {share:.4f}")
        kernel_ms = cuda_ms(lambda: cf.lookup_corr_fused(f1, pyr, cxy, r), 20)
        plain_ms = cuda_ms(lambda: cf.lookup_corr_plain(f1, pyr, cxy, r), 2)
        nbytes, flops, (b_ms, b_by) = k1_bound(f1, pyr, cxy, got, r, dtype)
        log(f"K1 {name} ({label} coords): kernel_ms {kernel_ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}; {nbytes / 1e9:.3f} "
            f"GB, {flops / 1e9:.2f} GFLOP)")
        stats.setdefault(key, {})[label] = dict(
            ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, library_ms=None)


def check_k2(q, k, v, scale: float, label: str) -> float:
    """K2 against its plain version on the same inputs; returns the
    largest output deviation. f32: online vs one-shot softmax
    reassociation (2e-5); bf16 output: 1 ulp of the largest entry (the
    kernel rounds p against the running max, the plain version against
    the row max). lse within 1e-4 in both."""
    import torch
    from fgt_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_mhsa(q, k, v, scale)
    want, want_lse = fa.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    err_lse = (lse - want_lse).abs().max().item()
    top = want.float().abs().max().item()
    tol = 2e-5 if q.dtype == torch.float32 else top * 2 ** -7
    log(f"K2 {label}: max_abs_err {err:.3g} (tol {tol:.3g}), "
        f"lse err {err_lse:.3g} (tol 1e-4)")
    if not (err <= tol and err_lse <= 1e-4):
        raise AssertionError(f"K2 {label} disagrees with its plain version")
    return err


def phase_k2(dtype, stats: dict):
    """K2 at the main-path shape: 5 windows x 4 groups x 4 heads = 80
    sequences of 13 frames x 10 x 18 = 2340 tokens, head dim 128 (ragged:
    the last 64-row query and key tiles hold 36 rows); in bf16 also at
    L = 65, one row past a tile edge."""
    import torch
    import torch.nn.functional as F
    from fgt_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(2)
    n, l, ch = 80, 2340, 128
    scale = ch ** -0.5
    name = str(dtype)[6:]
    if dtype == torch.bfloat16:
        check_k2(*(torch.randn(4, 65, ch, device="cuda", generator=g)
                   .to(dtype) for _ in range(3)), scale, f"{name} L=65")
    q, k, v = (torch.randn(n, l, ch, device="cuda", generator=g).to(dtype)
               for _ in range(3))
    err = check_k2(q, k, v, scale, f"{name} N={n} L={l}")
    kernel_ms = cuda_ms(lambda: fa.flash_mhsa(q, k, v, scale), 10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale), 3)
    # [1, N, L, ch]: batch 1 and N heads, the layout SDPA's fused paths take
    q4, k4, v4 = q[None], k[None], v[None]
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4), 10)
    item = q.element_size()
    nbytes = 4 * n * l * ch * item + n * l * 4
    flops = 4.0 * n * l * l * ch
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS if dtype ==
                       torch.bfloat16 else H100_F32_FLOPS)
    log(f"K2 {name}: kernel_ms {kernel_ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} "
        f"({b_by}); {flops / kernel_ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / kernel_ms:.3f} of the bound")
    stats[str(dtype)] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=err,
                             library_ms=library_ms)


def check_k45_ragged(q, k, v, do, scale: float):
    """K4 and K5 in bf16 at a ragged L against their plain versions on
    the plain forward's lse and dsum: 1 ulp of the largest entry."""
    import torch
    from fgt_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_attention_plain(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(-1)
    got = (fa.flash_attention_dq(q, k, v, do, lse, dsum, scale),
           *fa.flash_attention_dkv(q, k, v, do, lse, dsum, scale))
    want = (fa.flash_attention_dq_plain(q, k, v, do, lse, dsum, scale),
            *fa.flash_attention_dkv_plain(q, k, v, do, lse, dsum, scale))
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        top = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        log(f"K4/K5 bfloat16 L={q.shape[1]} {name}: max_abs_err {err:.3g} "
            f"(tol {top * 2 ** -7:.3g})")
        if not err <= top * 2 ** -7:
            raise AssertionError(f"K4/K5 {name} at L={q.shape[1]} "
                                 "disagrees")


def phase_k45(dtype, stats: dict, resources: dict):
    """K4 and K5 at the training shape: batch 2 x 4 groups x 4 heads = 32
    sequences of 5 frames x 10 x 18 = 900 tokens, head dim 128 (ragged:
    the last 64-row tile holds 4 rows); in bf16 also at L = 65, and K4's
    tensor-core body's registers, shared memory and spills."""
    import torch
    import torch.nn.functional as F
    from fgt_tpu_torch.ops import flash_attention as fa

    if dtype == torch.bfloat16:
        log("K4 bfloat16 body flash_dq_bf16_kernel: "
            f"{resources.get('flash_dq_bf16_kernel', 'not measured')}; "
            "dynamic shared memory 98304 B a block (q, dO, two k/v stages)")

    g = torch.Generator(device="cuda").manual_seed(4)
    n, l, ch = 32, 900, 128
    scale = ch ** -0.5
    if dtype == torch.bfloat16:
        check_k45_ragged(*(torch.randn(4, 65, ch, device="cuda", generator=g)
                           .to(dtype) for _ in range(4)), scale)
    q, k, v, do = (torch.randn(n, l, ch, device="cuda", generator=g).to(dtype)
                   for _ in range(4))
    out, lse = fa.flash_mhsa(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(-1)
    got = (fa.flash_attention_dq(q, k, v, do, lse, dsum, scale),
           *fa.flash_attention_dkv(q, k, v, do, lse, dsum, scale))
    plain = (fa.flash_attention_dq_plain(q, k, v, do, lse, dsum, scale),
             *fa.flash_attention_dkv_plain(q, k, v, do, lse, dsum, scale))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref_out = fa.flash_attention_plain(*leaves, scale)[0]
    auto = torch.autograd.grad(ref_out, leaves, do)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, c in zip(("dq", "dk", "dv"), got, plain, auto):
        top = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        err_auto = (a.float() - c.float()).abs().max().item()
        # f32: reassociated sums over 900 keys/queries; bf16 outputs:
        # 1 ulp of the largest entry against the plain version, 2 ulp
        # against autograd (whose dsum comes from the unrounded output)
        f32 = dtype == torch.float32
        tol = 1e-5 * max(1.0, top) if f32 else top * 2 ** -7
        tol_auto = 1e-5 * max(1.0, top) if f32 else top * 2 ** -6
        log(f"K4/K5 {str(dtype)[6:]} {name}: max_abs_err {err:.3g} "
            f"(tol {tol:.3g}), vs autograd {err_auto:.3g} "
            f"(tol {tol_auto:.3g}), max |{name}| {top:.3g}")
        if not (err <= tol and err_auto <= tol_auto):
            raise AssertionError(f"K4/K5 {name} disagrees")
        errs[name] = err
    dq_ms = cuda_ms(lambda: fa.flash_attention_dq(q, k, v, do, lse, dsum,
                                                  scale), 10)
    dkv_ms = cuda_ms(lambda: fa.flash_attention_dkv(q, k, v, do, lse, dsum,
                                                    scale), 50)
    dq_plain = cuda_ms(lambda: fa.flash_attention_dq_plain(
        q, k, v, do, lse, dsum, scale), 5)
    dkv_plain = cuda_ms(lambda: fa.flash_attention_dkv_plain(
        q, k, v, do, lse, dsum, scale), 5)
    # SDPA on [1, N, L, ch]: backward = (forward + backward) - forward,
    # from the kernels' device time (its autograd call is host-bound)
    q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
    do4 = do[None]
    fwd_ms = kernel_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                       10)
    fb_ms = kernel_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q4, k4, v4), (q4, k4, v4), do4), 10)
    lib_ms = fb_ms - fwd_ms
    item = q.element_size()
    rows = 2 * n * l * 4                              # lse, dsum (f32)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    for name, ms, pms, n_out, mats in (("dq", dq_ms, dq_plain, 1, 3),
                                       ("dkv", dkv_ms, dkv_plain, 2, 4)):
        nbytes = (4 + n_out) * n * l * ch * item + rows
        flops = 2.0 * mats * n * l * l * ch
        b_ms, b_by = bound(nbytes, flops, peak)
        err = errs["dq"] if name == "dq" else max(errs["dk"], errs["dv"])
        log(f"K{4 if name == 'dq' else 5} {str(dtype)[6:]}: kernel_ms "
            f"{ms:.4f} plain_ms {pms:.4f} library_ms {lib_ms:.4f} (SDPA "
            f"backward, dq+dk+dv) bound_ms {b_ms:.4f} ({b_by}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the bound")
        stats.setdefault(name, {})[str(dtype)] = dict(
            ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, library_ms=lib_ms)


def k3_window_counts(pyr, coords, r: int):
    """This run's in-level window cells of K3 (each read once) and the
    32-byte sectors their rows touch (the layout's own floor: a row of
    k+1 cells starts at any element), summed over pixels and levels."""
    import torch

    n = coords.shape[0] * coords.shape[1] * coords.shape[2]
    flat = coords.reshape(n, 2)
    item = pyr[0].element_size()
    dd = torch.arange(-r, r + 2, device=coords.device)
    pix = torch.arange(n, device=coords.device)[:, None]
    cells = sectors = 0
    for lvl, vol in enumerate(pyr):
        hl, wl = vol.shape[1:]
        c0 = torch.floor(flat / 2 ** lvl).clamp(-1e6, 1e6).long()
        xlo = (c0[:, :1] - r).clamp(min=0)
        ncol = ((c0[:, :1] + r + 2).clamp(max=wl) - xlo).clamp(min=0)
        ys = c0[:, 1:] + dd                                   # [n, k+1]
        rows = (ys >= 0) & (ys < hl) & (ncol > 0)
        cells += (rows * ncol).sum().item()
        start = ((pix * hl + ys.clamp(0, hl - 1)) * wl + xlo) * item
        end = start + ncol * item
        sectors += torch.where(rows, (end - 1) // 32 - start // 32 + 1,
                               0).sum().item()
    return cells, sectors


def k3_inputs(dtype, levels: int, B=46, H=60, W=108):
    """K3's main-path inputs: ``levels`` random all-pairs maps of 46 pairs
    x 60x108 pixels in ``dtype`` and f32 coords (a 8 px random flow) with
    far-out-of-range pixels and pixels on and past the level edges."""
    import torch
    from fgt_tpu_torch.ops import corr_lookup as cl

    g = torch.Generator(device="cuda").manual_seed(3)
    n = B * H * W
    pyr = [torch.randn(n, h, w, device="cuda", generator=g).to(dtype)
           for h, w in cl.pyramid_sizes(H, W, levels)]
    ys, xs = torch.meshgrid(torch.arange(H, device="cuda"),
                            torch.arange(W, device="cuda"), indexing="ij")
    coords = torch.stack([xs, ys], -1).float()[None].repeat(B, 1, 1, 1)
    coords = coords + 8 * torch.randn(B, H, W, 2, device="cuda", generator=g)
    coords[:, :4] = 1e4                       # far out of range: zero taps
    coords[:, 4:8] = -3e3
    coords[:, 8, :, 0] = W - 1                # on the right edge
    coords[:, 9, :, 0] = -0.5                 # straddling the left edge
    coords[:, 10, :, 1] = H - 0.75            # straddling the bottom edge
    return pyr, coords


def phase_k3(dtype, stats: dict):
    """K3 at the main-path shape: one GRU iteration over 46 pairs x
    60x108 pixels, 4 levels of all-pairs maps (60x108, 30x54, 15x27,
    7x13 — odd sizes floor-pooled) in ``dtype``, f32 coords that include
    far-out-of-range pixels and pixels on and past the level edges.
    Radius 4 and 3, f32 and bf16 taps: equal to the plain version (bf16:
    the plain f32 taps rounded once). Timed at radius 4 in both output
    dtypes, with the warp-per-pixel body it replaced beside it (and that
    body plus the cast
    the bf16 refine used to run after it), the plain version, the bound
    and the sector floor. F.grid_sample (align_corners=True, zero
    padding), one call per level on [N, 1, H_l, W_l] with a [N, k, k, 2]
    grid — the reference bilinear_sampler — is timed beside it as a
    yardstick only."""
    import torch
    from fgt_tpu_torch.ops import corr_lookup as cl

    r, L = 4, 4
    pyr, coords = k3_inputs(dtype, L)
    name = str(dtype)[6:]
    bf16 = torch.bfloat16
    for radius in (4, 3):
        want = cl.lookup_corr_pyramid_plain(pyr, coords, radius)
        top = want.abs().max().item()
        # same arithmetic in the same order, each product and sum rounded
        # on its own: equal; one f32 ulp of the largest tap is the bound
        tol = top * 2 ** -23
        outs = {"f32": cl.lookup_corr_pyramid(pyr, coords, radius),
                "bf16": cl.lookup_corr_pyramid(pyr, coords, radius,
                                               out_dtype=bf16)}
        if radius == r:
            outs["warp-per-pixel"] = cl.lookup_corr_pyramid_warp(pyr, coords,
                                                                r)
        torch.cuda.synchronize()
        for label, got in outs.items():
            ref = want.to(bf16) if got.dtype == bf16 else want
            diff = (got.float() - ref.float()).abs()
            err = diff.max().item()
            far = got[:, :8].abs().max().item()
            log(f"K3 {name} r {radius}, {label} taps: max_abs_err {err:.3g} "
                f"(tol {tol:.3g}{'; bf16: equal' if got.dtype == bf16 else ''}"
                f"; {int((diff > 0).sum())} of {got.numel()} taps differ; max "
                f"|tap| {top:.3g}); far-coord taps max {far}")
            if (got.dtype != (bf16 if label == "bf16" else torch.float32)
                    or not err <= (0.0 if got.dtype == bf16 else tol)
                    or far != 0.0):
                raise AssertionError(f"K3 ({label} taps, r {radius}) "
                                     f"disagrees with its plain version")
        if radius == r:
            errs = {"f32": (outs["f32"] - want).abs().max().item(),
                    "bf16": (outs["bf16"].float()
                             - want.to(bf16).float()).abs().max().item()}
        del outs, want
    times = {
        "warp": cuda_ms(lambda: cl.lookup_corr_pyramid_warp(pyr, coords, r),
                        20),
        "warp_cast": cuda_ms(lambda: cl.lookup_corr_pyramid_warp(
            pyr, coords, r).to(bf16), 20)}
    out = k3_numbers(pyr, coords, r, errs, name)
    log(f"K3 {name}: warp-per-pixel body {times['warp']:.4f} ms (f32 taps), "
        f"{times['warp_cast']:.4f} ms with the cast to bf16 after it; the "
        f"redesign {times['warp'] / out['f32']['ms']:.2f}x (f32 taps), "
        f"{times['warp_cast'] / out['bf16']['ms']:.2f}x (bf16 taps against "
        f"body + cast)")
    stats[str(dtype)] = out


def k3_numbers(pyr, coords, r: int, errs: dict, name: str) -> dict:
    """K3's times at radius ``r`` on ``pyr`` and ``coords``, with f32 and
    bf16 taps: the kernel, its plain version, F.grid_sample (one call per
    level on [N, 1, H_l, W_l] with a [N, k, k, 2] grid — the reference
    bilinear_sampler, align_corners=True, zero padding — a yardstick
    only), the bound and the sector floor of this run's windows.
    ``errs``: the kernel's max |err| per tap dtype. Returns {tap dtype:
    the kernel line's numbers}."""
    import torch
    import torch.nn.functional as F
    from fgt_tpu_torch.ops import corr_lookup as cl

    bf16 = torch.bfloat16
    n, k, L = coords.numel() // 2, 2 * r + 1, len(pyr)
    times = {o: cuda_ms(lambda: cl.lookup_corr_pyramid(
        pyr, coords, r, out_dtype=odt), 20)
        for o, odt in (("f32", torch.float32), ("bf16", bf16))}
    plain = {o: cuda_ms(lambda: cl.lookup_corr_pyramid_plain(
        pyr, coords, r, out_dtype=odt), 2)
        for o, odt in (("f32", torch.float32), ("bf16", bf16))}
    # the reference bilinear_sampler: dx on the slow axis of the [k, k]
    # grid (corr.py:37-43), coordinates normalized to [-1, 1]
    d = torch.arange(-r, r + 1, device="cuda", dtype=torch.float32)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)
    grids, vols = [], []
    for lvl, vol in enumerate(pyr):
        hl, wl = vol.shape[1:]
        c = coords.reshape(n, 1, 1, 2) / 2 ** lvl + delta
        scale = torch.tensor([2.0 / max(wl - 1, 1), 2.0 / max(hl - 1, 1)],
                             device="cuda")
        grids.append((c * scale - 1).to(vol.dtype))
        vols.append(vol[:, None])

    def library():
        # PyTorch's own kernel: cuDNN's sampler refuses batches this large
        with torch.backends.cudnn.flags(enabled=False):
            return [F.grid_sample(v, gr, mode="bilinear",
                                  padding_mode="zeros", align_corners=True)
                    for v, gr in zip(vols, grids)]

    want = cl.lookup_corr_pyramid_plain(pyr, coords, r)
    lib = torch.cat([o.reshape(n, k * k) for o in library()], -1)
    lib_err = (lib.float() - want.reshape(n, -1)).abs().max().item()
    library_ms = cuda_ms(library, 10)
    del grids, vols, lib, want
    # bytes this run's data needs: each in-level window cell read once,
    # the coords, the taps written once; the sector floor counts the
    # 32-byte sectors of the window rows in place of their cells
    cells, sectors = k3_window_counts(pyr, coords, r)
    item = pyr[0].element_size()
    taps = n * L * k * k
    flops = 9 * taps                          # 6 multiplies, 3 adds per tap
    out = {}
    for o, tap_bytes in (("f32", 4), ("bf16", 2)):
        rest = coords.numel() * 4 + taps * tap_bytes
        b_ms, b_by = bound(cells * item + rest, flops, H100_F32_FLOPS)
        floor_ms = (sectors * 32 + rest) / H100_BYTES_PER_S * 1e3
        log(f"K3 {name} r {r}, {o} taps: kernel_ms {times[o]:.4f} plain_ms "
            f"{plain[o]:.4f} library_ms {library_ms:.4f} (grid_sample, {L} "
            f"calls; max |diff| to the plain taps {lib_err:.3g}) bound_ms "
            f"{b_ms:.4f} ({b_by}; {(cells * item + rest) / 1e9:.3f} GB, "
            f"{flops / 1e9:.2f} GFLOP; {b_ms / times[o]:.3f} of the bound) "
            f"sector floor {floor_ms:.4f} ms ({(sectors * 32 + rest) / 1e9:.3f}"
            f" GB)")
        out[o] = dict(ms=times[o], plain_ms=plain[o], bound_ms=b_ms,
                      bound_by=b_by, max_abs_err=errs[o],
                      library_ms=library_ms)
    log(f"K3 {name} r {r}: windows {cells * item / 1e9:.4f} GB in cells, "
        f"{sectors * 32 / 1e9:.4f} GB in sectors "
        f"({sectors * 32 / n / 1e3:.3f} KB a pixel)")
    return out


def phase_k3_small(stats: dict):
    """K3 at RAFT small's shape: the bf16 all-pairs pyramid of one refine
    built from C = 128 features (46 pairs x 60x108 pixels, 4 levels), a
    smooth 8 px flow with far-out-of-range rows, radius 3. Equal to the
    plain version with f32 and bf16 taps; timed with its bound, the
    plain version and grid_sample."""
    import torch
    from fgt_tpu_torch.ops import corr_lookup as cl

    g = torch.Generator(device="cuda").manual_seed(7)
    B, H, W, C, r = 46, 60, 108, 128, 3
    f1, f2 = (torch.randn(B, H, W, C, device="cuda", generator=g)
              .to(torch.bfloat16) for _ in range(2))
    pyr = cl.build_corr_pyramid(f1, f2, 4, dtype=torch.bfloat16)
    del f1, f2
    coords = smooth_coords(B, H, W, g)
    coords[:, :2] = 1e4
    want = cl.lookup_corr_pyramid_plain(pyr, coords, r)
    errs = {}
    for o, odt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = cl.lookup_corr_pyramid(pyr, coords, r, out_dtype=odt)
        ref = want.to(odt)
        errs[o] = (got.float() - ref.float()).abs().max().item()
        far = got[:, :2].abs().max().item()
        log(f"K3 bfloat16 C=128 r {r}, {o} taps: max_abs_err {errs[o]:.3g} "
            f"(tol 0: equal); far-coord taps max {far}")
        if got.dtype != odt or errs[o] != 0.0 or far != 0.0:
            raise AssertionError(f"K3 at r {r} ({o} taps) disagrees with "
                                 "its plain version")
    del want
    stats["bfloat16 C128 r3"] = k3_numbers(pyr, coords, r, errs,
                                           "bfloat16 C=128")
    del pyr
    torch.cuda.empty_cache()


def phase_pyramid_build():
    """The all-pairs pyramid of one refine at the main-path shape (46
    pairs x 60x108 pixels, C = 256, bf16 storage), built 8 pairs at a
    time: from bf16 features (f32 product on TF32 tensor cores, exact for
    bf16-valued inputs — the port's path) and from the same values in
    f32 features (full-f32 product), which must agree."""
    import torch
    from fgt_tpu_torch.ops import corr_lookup as cl

    g = torch.Generator(device="cuda").manual_seed(5)
    f1, f2 = (torch.randn(46, 60, 108, 256, device="cuda", generator=g)
              .to(torch.bfloat16) for _ in range(2))
    times = {}
    for label, a, b in (("bf16 features, TF32 product", f1, f2),
                        ("f32 features, f32 product", f1.float(),
                         f2.float())):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pyr = cl.build_corr_pyramid(a, b, 4, dtype=torch.bfloat16)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        times[label] = cuda_ms(lambda: cl.build_corr_pyramid(
            a, b, 4, dtype=torch.bfloat16), 3)
        if label.startswith("bf16"):
            ref = pyr
        else:
            err = max((p.float() - q.float()).abs().max().item()
                      for p, q in zip(pyr, ref))
        log(f"pyramid build ({label}): {times[label]:.3f} ms; "
            f"{sum(p.numel() * 2 for p in pyr) / 1e9:.3f} GB stored, peak "
            f"{peak:.2f} GiB above the features")
        del pyr
    del ref
    top = 2 ** -7 * 16                        # bf16 ulp near the largest maps
    log(f"pyramid build: the two products' pyramids differ by at most "
        f"{err:.3g} (one bf16 ulp at |corr| ~ 16: {top:.3g})")
    if not err <= top:
        raise AssertionError("TF32 and f32 pyramid builds disagree")
    return times


def phase_refine_bf16():
    """RAFT refine in bf16 on a 64x64 pair (8x8 features; levels 8x8,
    4x4, 2x2, 1x1) at full width (random weights from seed 0), 20
    iterations, on the K1 path: with the kernel, then with its plain
    version in its place. Tolerance: the bf16 GRU on random weights
    carries a one-ulp tap difference through 20 iterations; on the CPU,
    flipping 0.5% of the taps by one bf16 ulp every iteration moved the
    upsampled flow by 0.45% of its largest value at most and 0.1% on the
    mean, so max |diff| <= 2^-5 and mean |diff| <= 2^-8 of the largest
    |flow|. Returns the kernel's (box, general) route counts."""
    import torch
    from fgt_tpu_torch.models import raft as raft_mod
    from fgt_tpu_torch.ops import corr_fused as cf

    frames, _ = synthetic_video(n=2, h=64, w=64, hole=8, y0=8, x0=8)
    model = raft_mod.init_raft(raft_mod.RAFT(),
                               torch.Generator().manual_seed(0))
    model = model.to("cuda", torch.bfloat16).eval()
    flows = []
    with torch.no_grad():
        fmap, net, inp = model.encode(torch.from_numpy(frames).cuda())
        for lookup in (cf.lookup_corr_fused, cf.lookup_corr_plain):
            raft_mod.lookup_corr_fused = lookup
            try:
                cf.reset_route_tiles()
                reset([cf.lookup_corr_fused])
                flows.append(model.refine(fmap[:1], fmap[1:], net[:1],
                                          inp[:1], 20)[1].float())
                torch.cuda.synchronize()
                if lookup is cf.lookup_corr_fused:
                    routes = cf.route_tiles()
                    launches = cf.lookup_corr_fused.launches
            finally:
                raft_mod.lookup_corr_fused = cf.lookup_corr_fused
    top = flows[1].abs().max().item()
    diff = (flows[0] - flows[1]).abs()
    log(f"RAFT refine bf16 64x64: K1 vs plain flow max |diff| "
        f"{diff.max().item():.4g} (tol {top * 2 ** -5:.4g}), mean "
        f"{diff.mean().item():.4g} (tol {top * 2 ** -8:.4g}); max |flow| "
        f"{top:.4g} px; K1 launches {launches}, routes {routes}")
    if launches != 20 or routes["box"] == 0:
        raise AssertionError("the bf16 refine did not run K1's box route")
    if not (diff.max().item() <= top * 2 ** -5
            and diff.mean().item() <= top * 2 ** -8):
        raise AssertionError("RAFT refine: K1 and its plain version disagree")
    return routes


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


def reset(counters):
    for c in counters:
        c.launches = 0


def read(counters) -> dict:
    return {c.__name__: c.launches for c in counters}


def expect_launches(label: str, launches: dict, want: dict):
    """``want``: counter name -> exact count, or None for "at least 1"."""
    for name, n in want.items():
        if (launches[name] <= 0) if n is None else (launches[name] != n):
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times, want "
                                 f"{'> 0' if n is None else n}: {launches}")


def phase_main_path(counters, corr: str, want: dict):
    """Object removal, 24 frames at 432x240, full width, bf16, on the
    ``corr`` path of s1; two passes (cold, warm). Returns (launches of the
    warm pass, its stage seconds)."""
    import torch
    from fgt_tpu_torch.ops import corr_fused as cf
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    frames, masks = synthetic_video()
    t0 = time.perf_counter()
    models = vi.Models("cuda", bf16=True, seed=0, corr=corr)
    torch.cuda.synchronize()
    log(f"main path ({corr}): models built in "
        f"{time.perf_counter() - t0:.2f} s")
    for label in ("cold", "warm"):   # the cold pass pays first-call costs
        torch.cuda.reset_peak_memory_stats()
        timer = vi.StageTimer("cuda")
        reset(counters)
        cf.reset_route_tiles()
        out = vi.inpaint(frames, masks, models, timer=timer)
        launches = read(counters)
        routes = cf.route_tiles()
        total = sum(timer.times.values())
        log(f"main path ({corr}) {label} stages (s): " + json.dumps(
            {k: round(v, 4) for k, v in timer.times.items()}))
        log(f"main path ({corr}) {label}: {len(frames)} frames in "
            f"{total:.3f} s = {len(frames) / total:.3f} frames/s; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
            f"launches {launches}")
        if corr == "fused":
            log(f"main path ({corr}) {label}: K1 routes of the (tile, level) "
                f"pairs {routes}, box share "
                f"{routes['box'] / max(1, sum(routes.values())):.4f}")
        if out.shape != (24, 240, 432, 3) or out.dtype != np.uint8:
            raise AssertionError(f"output {out.shape} {out.dtype}")
        keep = masks == 0
        if not np.array_equal(out[keep], frames[keep]):
            raise AssertionError("output differs from the input outside "
                                 "the hole")
        expect_launches(f"main path ({corr})", launches, want)
    hole_mean = out[masks > 0].astype(np.float64).mean()
    log(f"main path ({corr}): output ok; mean value inside the hole "
        f"{hole_mean:.2f}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del models
    torch.cuda.empty_cache()
    return launches, dict(timer.times), peak


def write_pngs(root: str, frames: np.ndarray) -> str:
    from fgt_tpu_torch.pipeline import image_io

    os.makedirs(root, exist_ok=True)
    for i, fr in enumerate(frames):
        image_io.write_png(os.path.join(root, f"{i:05d}.png"), fr)
    return root


def scan_writer():
    """The tests' JPEG scan-script writer (``write_scans`` and libjpeg's
    ``SIMPLE_PROGRESSION`` from ``tests/torch_port_jpeg_encoder.py``,
    numpy only): the port's own encoder writes only baseline files."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_port_jpeg_encoder import SIMPLE_PROGRESSION, write_scans

    return write_scans, SIMPLE_PROGRESSION


def write_jpegs(root: str, frames: np.ndarray, quality: int = 90) -> str:
    """``NNNNN.jpg`` files, baseline 4:2:0 (as DAVIS and YouTube-VOS
    ship their frames), by the port's encoder."""
    from fgt_tpu_torch.core.jpeg_encode import encode_jpeg

    os.makedirs(root, exist_ok=True)
    for i, fr in enumerate(frames):
        with open(os.path.join(root, f"{i:05d}.jpg"), "wb") as f:
            f.write(encode_jpeg(fr, quality, "420"))
    return root


CLI_RANDOM = ["--raft_model", "/nonexistent", "--lafc_ckpts", "/nonexistent",
              "--fgt_ckpts", "/nonexistent", "--imgH", "240", "--imgW", "432",
              "--device", "cuda"]


def run_cli(label: str, counters, argv: list, want: dict):
    """One full-width CLI run (random weights from seed 0, bf16) with the
    counts reset just before and read just after. Returns (output,
    launches, seconds)."""
    import torch
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t0 = time.perf_counter()
    path = vi.main(CLI_RANDOM + argv)      # argv's flags win
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    out = np.load(path)
    with open(os.path.join(os.path.dirname(path), "timings.json")) as f:
        stages = json.load(f)["stages"]
    work = sum(v for k, v in stages.items() if k[:2] in ("s1", "s2", "s3",
                                                        "s4", "s5", "s6"))
    log(f"{label} stages (s): " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))
    log(f"{label}: {out.shape[0]} frames, s1-s6 {work:.3f} s = "
        f"{out.shape[0] / work:.3f} frames/s; CLI wall {wall:.2f} s (models "
        f"built, PNG/npy I/O included); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{launches}")
    expect_launches(label, launches, want)
    return out, launches, wall


def phase_modes(counters, root: str):
    """The other two modes and --Nonlocal through the CLI at full width:
    watermark removal from PNG directories (frames premasked, default
    path), video extrapolation to a 1.2x canvas on the pyramid path, and
    --Nonlocal on a 12-frame clip on the pyramid path."""
    frames, masks = synthetic_video()
    hole = masks > 0
    premasked = frames * (~hole)[..., None].astype(np.uint8)
    fdir = write_pngs(f"{root}/wm/frames", premasked)
    mdir = write_pngs(f"{root}/wm/masks", masks * 255)
    out, _, _ = run_cli("watermark removal", counters, [
        "--mode", "watermark_removal", "--path", fdir, "--path_mask", mdir,
        "--outroot", f"{root}/wm/out"],
        {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0,
         "flash_mhsa": None})
    if out.shape != frames.shape or out.dtype != np.uint8:
        raise AssertionError(f"watermark output {out.shape} {out.dtype}")
    if not np.array_equal(out[~hole], frames[~hole]):
        raise AssertionError("watermark output differs outside the hole")
    log(f"watermark removal: output ok; mean value inside the hole "
        f"{out[hole].astype(np.float64).mean():.2f}")

    np.save(f"{root}/frames.npy", frames)
    np.save(f"{root}/masks.npy", masks)
    out, _, _ = run_cli("video extrapolation", counters, [
        "--mode", "video_extrapolation", "--H_scale", "1.2", "--W_scale",
        "1.2", "--fused_corr", "off", "--path", f"{root}/frames.npy",
        "--outroot", f"{root}/ex/out"],
        {"lookup_corr_fused": 0, "lookup_corr_pyramid": 20,
         "flash_mhsa": None})
    if out.shape != (24, 288, 516, 3) or out.dtype != np.uint8:
        raise AssertionError(f"extrapolation output {out.shape} {out.dtype}")
    y0, x0 = (288 - 240) // 2, (516 - 432) // 2
    if not np.array_equal(out[:, y0:y0 + 240, x0:x0 + 432], frames):
        raise AssertionError("extrapolation centre differs from the input")
    log(f"video extrapolation: output [24, 288, 516, 3] ok, centre "
        f"byte-identical; mean value of the border "
        f"{out.astype(np.float64).mean():.2f} over the canvas")

    np.save(f"{root}/frames12.npy", frames[:12])
    np.save(f"{root}/masks12.npy", masks[:12])
    # s1: 22 pairs in one refine (20 K3); s3b: 36 pairs per direction
    out, _, _ = run_cli("--Nonlocal", counters, [
        "--Nonlocal", "1", "--fused_corr", "off", "--path",
        f"{root}/frames12.npy", "--path_mask", f"{root}/masks12.npy",
        "--outroot", f"{root}/nl/out"],
        {"lookup_corr_fused": 0, "lookup_corr_pyramid": 60,
         "flash_mhsa": None})
    if out.shape != (12, 240, 432, 3) or not np.array_equal(
            out[~hole[:12]], frames[:12][~hole[:12]]):
        raise AssertionError("--Nonlocal output wrong outside the hole")
    log("--Nonlocal: output ok")


def phase_flow_extract(counters, root: str):
    """Offline flow extraction: 2 synthetic videos x 8 frames at 432x240
    (a PNG and a JPEG directory), f32 RAFT (random weights, seed 0) on
    the pyramid path, 4 pairs per call: 2 x 7 x 2 .flo files read back
    finite at [240, 432, 2]; K3 launches 2 videos x 2 directions x 2
    calls x 20 iterations."""
    import torch
    from fgt_tpu_torch.core import flow_io
    from fgt_tpu_torch.pipeline import flow_extract

    for v, write in enumerate((write_pngs, write_jpegs)):
        frames, _ = synthetic_video(n=8, seed=10 + v)
        write(f"{root}/fx/data/video{v}", frames)
    reset(counters)
    t0 = time.perf_counter()
    n = flow_extract.main(["--datapath", f"{root}/fx/data", "--outroot",
                           f"{root}/fx/out", "--raft_model", "/nonexistent",
                           "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    files = sorted(os.path.join(d, f) for d, _, fs in
                   os.walk(f"{root}/fx/out") for f in fs if f.endswith(".flo"))
    flows = [flow_io.read_flow(f) for f in files]
    log(f"flow extraction: {n} frames, {len(files)} .flo files in "
        f"{wall:.2f} s (model built, PNG/JPEG I/O included); launches "
        f"{launches}; "
        f"max |flow| {max(np.abs(f).max() for f in flows):.3f} px")
    if len(files) != 28 or any(f.shape != (240, 432, 2)
                               or not np.isfinite(f).all() for f in flows):
        raise AssertionError("flow extraction output wrong")
    expect_launches("flow extraction", launches,
                    {"lookup_corr_pyramid": 160, "lookup_corr_fused": 0})


def phase_batch(counters, root: str):
    """The batch driver: 2 synthetic videos x 8 frames at 432x240 (a PNG
    and a JPEG frame directory, PNG masks) through one resident model set
    (full width, bf16, default path); every summary row must be ok."""
    import torch
    from fgt_tpu_torch.pipeline import batch

    for v, write in enumerate((write_pngs, write_jpegs)):
        frames, masks = synthetic_video(n=8, seed=20 + v)
        write(f"{root}/bt/videos/v{v}", frames)
        write_pngs(f"{root}/bt/masks/v{v}", masks * 255)
    reset(counters)
    t0 = time.perf_counter()
    rows = batch.main(["--videos_root", f"{root}/bt/videos", "--masks_root",
                       f"{root}/bt/masks", "--outroot", f"{root}/bt/out"]
                      + CLI_RANDOM)
    torch.cuda.synchronize()
    launches = read(counters)
    summary = [(r["video"], r["ok"], r["wall_s"]) for r in rows]
    log(f"batch: {len(rows)} videos in {time.perf_counter() - t0:.2f} s "
        f"(models built once); rows {summary}; launches {launches}")
    if len(rows) != 2 or not all(r["ok"] for r in rows):
        raise AssertionError(f"batch rows not all ok: {rows}")
    expect_launches("batch", launches, {"lookup_corr_fused": 40,
                                        "flash_mhsa": None})


def phase_small(counters, root: str):
    """Object removal with RAFT --small through the CLI at full width (24
    frames at 432x240, bf16), twice on each s1 path (cold: the small
    model's first convolutions in the process; warm): the K1 path (K1 at
    C = 128, r = 3: 20 launches, K3 none) and the pyramid path
    (--fused_corr off: K3 at r = 3, 20 launches, K1 none). Returns the
    warm runs' s1 seconds by path."""
    from fgt_tpu_torch.ops import corr_fused as cf

    frames, masks = synthetic_video()
    hole = masks > 0
    np.save(f"{root}/sm_frames.npy", frames)
    np.save(f"{root}/sm_masks.npy", masks)
    s1 = {}
    for fused_corr, want in (
            ("auto", {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0}),
            ("off", {"lookup_corr_fused": 0, "lookup_corr_pyramid": 20})):
        for run in ("cold", "warm"):
            label = f"--small (--fused_corr {fused_corr}, {run})"
            cf.reset_route_tiles()
            out, _, _ = run_cli(label, counters, [
                "--small", "--fused_corr", fused_corr, "--path",
                f"{root}/sm_frames.npy", "--path_mask",
                f"{root}/sm_masks.npy", "--outroot",
                f"{root}/sm_{fused_corr}_{run}"], dict(want, flash_mhsa=None))
            if fused_corr == "auto":
                log(f"{label}: K1 routes of the (tile, level) pairs "
                    f"{cf.route_tiles()}")
            if out.shape != frames.shape or out.dtype != np.uint8 or \
                    not np.array_equal(out[~hole], frames[~hole]):
                raise AssertionError(f"{label}: output wrong outside the "
                                     "hole")
        with open(f"{root}/sm_{fused_corr}_warm/timings.json") as f:
            s1[fused_corr] = json.load(f)["stages"]["s1_raft"]
        log(f"--small (--fused_corr {fused_corr}): output ok; mean value "
            f"inside the hole {out[hole].astype(np.float64).mean():.2f}")
    log(f"--small s1, warm, same run: K1 path {s1['auto']:.4f} s, pyramid "
        f"path (K3) {s1['off']:.4f} s")
    return s1


def phase_alternate(counters, root: str):
    """Object removal with --alternate_corr (RAFT big) through the CLI,
    --fused_corr off given too: s1 runs K1's f32 body, 20 launches, and
    no K3 and no bf16 K1 (whose route counters stay 0)."""
    from fgt_tpu_torch.ops import corr_fused as cf

    frames, masks = synthetic_video()
    hole = masks > 0
    np.save(f"{root}/alt_frames.npy", frames)
    np.save(f"{root}/alt_masks.npy", masks)
    cf.reset_route_tiles()
    out, _, _ = run_cli("--alternate_corr", counters, [
        "--alternate_corr", "--fused_corr", "off", "--path",
        f"{root}/alt_frames.npy", "--path_mask", f"{root}/alt_masks.npy",
        "--outroot", f"{root}/alt"],
        {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0,
         "flash_mhsa": None})
    routes = cf.route_tiles()
    log(f"--alternate_corr: bf16 K1 route counts {routes} (0: every K1 "
        f"launch took the f32 body)")
    if sum(routes.values()) != 0:
        raise AssertionError("--alternate_corr launched K1's bf16 body")
    if not np.array_equal(out[~hole], frames[~hole]):
        raise AssertionError("--alternate_corr output wrong outside the hole")
    log("--alternate_corr: output ok")


def phase_evaluate(counters, root: str):
    """The evaluation driver on 2 synthetic videos x 24 frames at 432x240
    (PNG directories), models resident (full width, bf16, random
    weights), VFID from a random-init I3D state dict saved as .pt (I3D in
    f32, TF32 off). Every number finite, eval.json written, 40 K1
    launches; then one clip's I3D features on the card against the CPU's
    (16 frames, a 120x216 crop), within 1e-4 of the largest |feature|
    (f32 convolution reassociation, as the CPU test's bound)."""
    import torch
    from fgt_tpu_torch.core import vfid
    from fgt_tpu_torch.pipeline import evaluate

    for v in range(2):
        frames, masks = synthetic_video(seed=30 + v)
        write_pngs(f"{root}/ev/frames/v{v}", frames)
        write_pngs(f"{root}/ev/masks/v{v}", masks * 255)
    model = vfid.init_i3d(vfid.I3D(), torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), f"{root}/ev/i3d.pt")
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t0 = time.perf_counter()
    summary = evaluate.main([
        "--frames", f"{root}/ev/frames", "--masks", f"{root}/ev/masks",
        "--outroot", f"{root}/ev/out", "--raft_model", "/nonexistent",
        "--lafc_ckpts", "/nonexistent", "--fgt_ckpts", "/nonexistent",
        "--vfid_ckpt", f"{root}/ev/i3d.pt", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    nums = {k: summary[k] for k in ("psnr", "ssim", "l1", "l2", "vfid",
                                    "fps")}
    log(f"evaluation: {summary['num_videos']} videos, {summary['frames']} "
        f"frames; " + json.dumps(nums) + f"; driver wall {wall:.2f} s "
        f"(models built, PNG I/O included); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; I3D "
        f"{vfid.F32_PRECISION}; launches {launches}")
    if not all(np.isfinite(v) for v in nums.values()) or \
            not os.path.exists(f"{root}/ev/out/eval.json"):
        raise AssertionError("evaluation: a number is not finite or "
                             "eval.json is missing")
    expect_launches("evaluation", launches, {"lookup_corr_fused": 40,
                                             "lookup_corr_pyramid": 0,
                                             "flash_mhsa": None})
    frames, _ = synthetic_video(seed=30)
    clip = vfid.VFIDScorer(clip_len=16, device="cpu").clips(
        frames)[:1, :, :120, :216]
    feats = []
    for dev in ("cuda", "cpu"):
        with torch.inference_mode(), vfid.f32_precision():
            feats.append(model.to(dev)(torch.from_numpy(clip).to(dev))
                         .float().cpu().numpy())
    err = np.abs(feats[0] - feats[1]).max()
    top = np.abs(feats[1]).max()
    log(f"evaluation: I3D features of one clip, card vs CPU: max |diff| "
        f"{err:.3g} (tol {1e-4 * top:.3g}, max |feature| {top:.3g})")
    if not err <= 1e-4 * top:
        raise AssertionError("I3D features differ between the card and "
                             "the CPU")


def phase_debug_flags(counters, root: str):
    """One 6-frame CLI run with --vis_flows --vis_completed_flows
    --vis_prop --vis_frame --profile and an --opt YAML that sets
    raft_iters to 3 (K1 launches 3, not 20); the debug directories hold
    their files and the trace holds K1's kernel."""
    frames, masks = synthetic_video(n=6)
    os.makedirs(f"{root}/dbg", exist_ok=True)
    np.save(f"{root}/dbg/frames.npy", frames)
    np.save(f"{root}/dbg/masks.npy", masks)
    with open(f"{root}/dbg/opt.yaml", "w") as f:
        f.write("# overrides the flags\nraft_iters: 3\n")
    out_dir = f"{root}/dbg/out"
    run_cli("debug flags", counters, [
        "--path", f"{root}/dbg/frames.npy", "--path_mask",
        f"{root}/dbg/masks.npy", "--outroot", out_dir, "--vis_flows",
        "--vis_completed_flows", "--vis_prop", "--vis_frame", "--profile",
        f"{root}/dbg/trace", "--opt", f"{root}/dbg/opt.yaml"],
        {"lookup_corr_fused": 3, "lookup_corr_pyramid": 0,
         "flash_mhsa": None})
    want = {f"{d}/{direction}_{kind}": 5 for d in ("flow", "completed_flow")
            for direction in ("forward", "backward") for kind in ("flo",
                                                                  "png")}
    want.update({d: 6 for d in ("prop_frames", "masks_left",
                                "prop_frames_npy", "masks_left_npy",
                                "frames")})
    counts = {d: len(os.listdir(os.path.join(out_dir, d))) for d in want}
    trace = f"{root}/dbg/trace/trace.json"
    with open(trace) as f:
        text = f.read()
    log(f"debug flags: files {counts}; trace {len(text) / 1e6:.1f} MB, "
        f"K1 kernel in it: {'corr_fused' in text}")
    if counts != want or "corr_fused" not in text:
        raise AssertionError(f"debug flags: want {want} and K1 in the trace")


def phase_jpeg_fixtures() -> dict:
    """(a) The host JPEG decoder built here against the committed
    fixtures (``tests/data/jpeg``: cv2-, Pillow- and test-encoder-written
    files of every layout it reads — baseline, progressive with and
    without restarts, a progressive file that leaves its coefficients
    unrefined (block smoothing), 4:1:1, CMYK, YCCK, several sequential
    scans, an EXIF-rotated one and one whose samples saturate — each
    beside cv2's decode as PNG): bit-equal under cv2's colour semantics.
    Then the decode time of an 854x480 4:2:0 q90 frame (DAVIS's size),
    baseline and progressive (libjpeg's simple progression, written by
    the tests' encoder), beside the PNG reader's on the same frame."""
    from fgt_tpu_torch.core import jpeg
    from fgt_tpu_torch.pipeline import image_io

    names = sorted(f for f in os.listdir(JPEG_FIXTURES) if f.endswith(".jpg"))
    if len(names) < 29:
        raise AssertionError(f"JPEG fixtures missing: {names}")
    with open(os.path.join(JPEG_FIXTURES, "arith_decodes.json")) as f:
        digests = json.load(f)
    for name in names:
        got = jpeg.read_jpeg(os.path.join(JPEG_FIXTURES, name), "color")
        png = os.path.join(JPEG_FIXTURES, name[:-4] + ".png")
        if name in digests:
            same = hashlib.sha256(got.tobytes()).hexdigest() == digests[name]
        else:
            same = np.array_equal(got, image_io.read_png(png))
        if not same:
            raise AssertionError(f"JPEG fixture {name}: the decode differs "
                                 f"from cv2's")
    frame = davis_clip(n=1)[0][0]
    from fgt_tpu_torch.core.jpeg_encode import encode_jpeg, quantized_blocks

    write_scans, progression = scan_writer()

    data = encode_jpeg(frame, 90, "420")
    blocks, factors, tables = quantized_blocks(frame, 90, "420")
    prog = write_scans(blocks, factors, tables, 854, 480, progression,
                       progressive=True)
    if not np.array_equal(jpeg.decode_jpeg(prog), jpeg.decode_jpeg(data)):
        raise AssertionError("the progressive frame decodes unlike the "
                             "baseline one of the same coefficients")
    arith = {}
    for name in ("arith", "arith_prog"):
        with open(os.path.join(JPEG_FIXTURES, f"{name}_854_420_q90.jpg"),
                  "rb") as f:
            arith[name] = f.read()
    with tempfile.TemporaryDirectory() as d:
        png = os.path.join(d, "f.png")
        image_io.write_png(png, frame)
        times = {}
        for name, fn in (("jpeg", lambda: jpeg.decode_jpeg(data)),
                         ("progressive", lambda: jpeg.decode_jpeg(prog)),
                         ("arith", lambda: jpeg.decode_jpeg(arith["arith"])),
                         ("arith_prog",
                          lambda: jpeg.decode_jpeg(arith["arith_prog"])),
                         ("png", lambda: image_io.read_png(png))):
            fn()
            reps = 3 if name == "png" else 30
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times[name] = 1e3 * (time.perf_counter() - t0) / reps
    log(f"JPEG fixtures: {len(names)} files bit-equal to cv2's decode; "
        f"decode of an 854x480 4:2:0 q90 frame: baseline ({len(data)} "
        f"bytes) {times['jpeg']:.3f} ms, progressive ({len(prog)} bytes, 10 "
        f"scans) {times['progressive']:.3f} ms, the PNG reader on the same "
        f"frame {times['png']:.3f} ms (host CPU, one thread)")
    log(f"JPEG arithmetic-coded decode of an 854x480 4:2:0 q90 frame "
        f"(libjpeg-turbo's encoder, the same frame): SOF9 "
        f"({len(arith['arith'])} bytes) {times['arith']:.3f} ms, SOF10 "
        f"({len(arith['arith_prog'])} bytes, 10 scans) "
        f"{times['arith_prog']:.3f} ms (host CPU, one thread)")
    return times


def davis_clip(n: int = 24):
    """A DAVIS-style clip: 854x480 frames (bench.py's smoothed noise,
    panning 4 px a frame) with a 112 px square hole moving with it."""
    return synthetic_video(n=n, h=480, w=854, hole=112, y0=180, x0=320,
                           pan=4, seed=3)


def k2_at_window_shapes(shapes: list) -> dict:
    """K2 against its plain version at each (N, L) the exact windows gave
    it, in f32 and bf16 (``check_k2``'s tolerances), and its bf16 time at
    each shape. Returns {(N, L): ms}."""
    import torch
    from fgt_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(4)
    ms = {}
    for n, l, ch in sorted(set(shapes)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(n, l, ch, device="cuda", generator=g)
                       .to(dtype) for _ in range(3))
            check_k2(q, k, v, ch ** -0.5,
                     f"{str(dtype)[6:]} exact window N={n} L={l}")
        ms[(n, l)] = cuda_ms(lambda: fa.flash_mhsa(q, k, v, ch ** -0.5), 10)
    return ms


def phase_jpeg_clip(counters, root: str) -> dict:
    """(b), (c) Object removal through the CLI from a DAVIS-style JPEG
    clip (24 frames 854x480, baseline 4:2:0, PNG masks) at 432x240, full
    width, bf16, on the K1 path: the default run (batched windows, device
    PCG), then ``--exact_windows`` (one FGT forward per window: 8, 12,
    13, 12 and 11 frames, so 5 x 4 = 20 K2 launches, each of whose shapes
    is then held against K2's plain version in f32 and bf16), then
    ``--host_diffusion`` (s2's regionfill by the host's multigrid solve).
    Each output [24, 240, 432, 3] u8, within 1 of the resized source
    outside the hole."""
    from fgt_tpu_torch.ops import flash_attention as fa
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    frames, masks = davis_clip()
    jdir = write_jpegs(f"{root}/davis/frames", frames)
    mdir = write_pngs(f"{root}/davis/masks", masks * 255)
    source = vi.load_frames(jdir, 240, 432)[0]
    hole = vi.load_masks(mdir, 240, 432) > 0
    shapes, real_kernel = [], fa._kernel

    def recording_kernel(lib, name, n_ptrs):
        """K2's entry point, noting each launch's (N, L, ch); the launch
        count stays the wrapper's own."""
        launch = real_kernel(lib, name, n_ptrs)
        if name != "flash_attention_forward":
            return launch

        def call(*args):
            shapes.append((args[n_ptrs], args[n_ptrs + 1], 128))
            return launch(*args)
        return call

    stats = {}
    for label, flags, k2 in (("default", [], 4),
                             ("--exact_windows", ["--exact_windows"], 20),
                             ("--host_diffusion", ["--host_diffusion"], 4)):
        out_dir = f"{root}/davis/out_{label.strip('-')}"
        fa._kernel = recording_kernel
        shapes.clear()
        try:
            out, _, _ = run_cli(f"JPEG clip {label}", counters, [
                "--path", jdir, "--path_mask", mdir, "--outroot", out_dir]
                + flags, {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0,
                          "flash_mhsa": k2})
        finally:
            fa._kernel = real_kernel
        with open(f"{out_dir}/timings.json") as f:
            stats[label] = dict(json.load(f)["stages"],
                                k2_shapes=list(shapes))
        err = np.abs(out.astype(np.float64) - source)[~hole].max()
        if out.shape != (24, 240, 432, 3) or out.dtype != np.uint8 or err > 1:
            raise AssertionError(f"JPEG clip {label}: output {out.shape} "
                                 f"{out.dtype}, max |out - source| outside "
                                 f"the hole {err}")
    exact = stats["--exact_windows"]["k2_shapes"]
    frames_per_window = sorted(l // 180 for _, l, _ in exact)  # 180 tokens
    want = sorted([8, 12, 13, 12, 11] * 4)                      # a frame
    log(f"JPEG clip --exact_windows: K2 shapes {sorted(set(exact))} "
        f"(frames a window x 4 blocks: {frames_per_window})")
    if frames_per_window != want or any(l % 180 for _, l, _ in exact):
        raise AssertionError(f"exact windows: K2 shapes {exact}, want "
                             f"windows of {want} frames")
    ms = k2_at_window_shapes(exact)
    k2_total = sum(ms[(n, l)] for n, l, _ in exact)
    batched = stats["default"]["k2_shapes"]
    n, l, _ = batched[0]
    log(f"JPEG clip: K2 bf16 ms at the exact windows' shapes "
        + ", ".join(f"N={a} L={b}: {t:.4f}" for (a, b), t in ms.items())
        + f"; 20 launches {k2_total:.3f} ms against the batched path's "
        f"{len(batched)} at N={n} L={l}")
    s6 = {k: stats[k]["s6_fgt"] for k in ("default", "--exact_windows")}
    s2 = {k: stats[k]["s2_lafc"] for k in ("default", "--host_diffusion")}
    log(f"JPEG clip: s6 {s6['--exact_windows']:.4f} s "
        f"({24 / s6['--exact_windows']:.2f} frames/s) with --exact_windows "
        f"against {s6['default']:.4f} s ({24 / s6['default']:.2f} frames/s) "
        f"batched; s2 {s2['--host_diffusion']:.4f} s with --host_diffusion "
        f"against {s2['default']:.4f} s with the device PCG; s0 frame load "
        f"(24 JPEG frames decoded and resized) "
        f"{stats['default']['s0_load_frames']:.4f} s")
    return stats


def psnr(a, b) -> float:
    err = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return float("inf") if err == 0 else 10 * np.log10(255.0 ** 2 / err)


def phase_dataset_prep(counters, root: str, smi: str, vanilla_s: dict,
                       vanilla_peak: float) -> dict:
    """(d) A benchmark folder prepared with the port's own tools, then
    object removal on it: phase 6's 24 frames at 432x240 through
    ``readers.save_frames_to_dir``; moving-stroke masks
    (``core.masks.get_video_masks_by_moving_random_stroke(24, 432, 240,
    seed=0)``) saved by ``MaskReader.save_files``; their boxes
    (``MaskReader.get_bboxes``) rasterised into a ``MaskGenerator``
    folder. Both folders are read back through the readers (frames and
    masks equal to what was written), then run through the CLI at full
    width (bf16, random weights from seed 0, the K1 path), each output
    [24, 240, 432, 3] u8, byte-identical to the input outside the hole,
    with K1 20 and K2 4 launches; frames/s and peak memory beside phase
    6's warm pass. The stroke run's result goes through
    ``FrameReader.write_files_to_video`` (an MJPG AVI) and back through
    ``video_io.read_video``: 24 frames at >= 36 dB PSNR."""
    import torch
    from fgt_tpu_torch.core import masks as core_masks
    from fgt_tpu_torch.core import video_io
    from fgt_tpu_torch.data import readers

    t0 = time.perf_counter()
    frames, _ = synthetic_video()
    fdir = f"{root}/prep/frames"
    readers.save_frames_to_dir(list(frames), fdir)
    strokes = core_masks.get_video_masks_by_moving_random_stroke(
        24, 432, 240, seed=0)
    writer = readers.MaskReader(None, read=False)
    writer.set_files(strokes)
    sdir = f"{root}/prep/masks_stroke"
    writer.save_files(sdir)
    stroke_reader = readers.MaskReader(sdir)
    boxes = [stroke_reader.get_bboxes(i) for i in range(len(stroke_reader))]
    bdir = f"{root}/prep/masks_bbox"
    readers.MaskGenerator(bdir, (432, 240), boxes)
    prep_s = time.perf_counter() - t0
    back = readers.FrameReader(fdir)
    if len(back) != 24 or not all(np.array_equal(a, b)
                                  for a, b in zip(back, frames)):
        raise AssertionError("prepared frames read back differ")
    if not all(np.array_equal(a, b) for a, b in zip(stroke_reader, strokes)):
        raise AssertionError("prepared stroke masks read back differ")
    box_masks = readers.MaskReader(bdir).files
    hole_share = {"stroke": float(np.mean(np.stack(strokes) > 0)),
                  "bbox": float(np.mean(np.stack(box_masks) > 0))}
    log(f"dataset prep: 24 frames, 24 stroke masks and 24 box masks "
        f"({sum(len(b) for b in boxes)} boxes) written in {prep_s:.2f} s; "
        f"hole share stroke {hole_share['stroke']:.4f}, bbox "
        f"{hole_share['bbox']:.4f}")
    want = {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0,
            "flash_mhsa": 4}
    stats = {}
    for label, mdir, hole in (("stroke", sdir, np.stack(strokes) > 0),
                              ("bbox", bdir, np.stack(box_masks) > 0)):
        out_dir = f"{root}/prep/out_{label}"
        out, _, wall = run_cli(f"dataset prep {label} masks", counters, [
            "--path", fdir, "--path_mask", mdir, "--outroot", out_dir], want)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if out.shape != (24, 240, 432, 3) or out.dtype != np.uint8:
            raise AssertionError(f"dataset prep {label}: output {out.shape} "
                                 f"{out.dtype}")
        if not np.array_equal(out[~hole], frames[~hole]):
            raise AssertionError(f"dataset prep {label}: output differs "
                                 f"from the input outside the hole")
        with open(f"{out_dir}/timings.json") as f:
            stages = json.load(f)["stages"]
        work = sum(v for k, v in stages.items() if k[:2] in (
            "s1", "s2", "s3", "s4", "s5", "s6"))
        stats[label] = {"frames_per_s": 24 / work, "peak_gib": peak,
                        "out": out}
    vanilla_fps = 24 / sum(vanilla_s.values())
    log("dataset prep vs phase 6, warm, same run: " + "; ".join(
        f"{k} masks {v['frames_per_s']:.3f} frames/s, peak "
        f"{v['peak_gib']:.2f} GiB" for k, v in stats.items())
        + f"; phase 6 (56x56 moving square) {vanilla_fps:.3f} frames/s, "
        f"peak {vanilla_peak:.2f} GiB; {smi}")
    video = readers.FrameReader(None, read=False)
    video.set_files(list(stats["stroke"]["out"]))
    avi = f"{root}/prep/result.avi"
    t0 = time.perf_counter()
    video.write_files_to_video(avi)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read = video_io.read_video(avi)
    read_s = time.perf_counter() - t0
    quality = psnr(np.stack(read), stats["stroke"]["out"]) if \
        len(read) == 24 else 0.0
    log(f"dataset prep: result.avi {os.path.getsize(avi)} bytes, 24 frames "
        f"written in {write_s:.3f} s, read back in {read_s:.3f} s "
        f"({len(read)} frames), PSNR {quality:.2f} dB")
    if len(read) != 24 or quality < 36:
        raise AssertionError(f"dataset prep AVI: {len(read)} frames at "
                             f"{quality:.2f} dB, want 24 at >= 36")
    return {k: {m: v[m] for m in ("frames_per_s", "peak_gib")}
            for k, v in stats.items()}


MSGPACK_FIXTURES = os.path.join(REPO, "tests", "data", "msgpack")


def check_msgpack_fixtures(root: str = MSGPACK_FIXTURES) -> dict:
    """The committed flax-written fixtures (``tests/data/msgpack``, made by
    ``tests/test_torch_port_msgpack.py``) read by the port's
    ``load_pytree``: every leaf of ``manifest.json`` at its shape and
    dtype with the stored sha256 of its bytes and its sum (bfloat16 by
    its bits). Returns {file: leaves checked}; raises on any mismatch."""
    import hashlib

    import torch
    from fgt_tpu_torch.utils import checkpoint

    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    checked = {}
    for name, leaves in sorted(manifest.items()):
        tree = checkpoint.load_pytree(os.path.join(root, name))
        for path, want in leaves.items():
            leaf = tree
            for key in path.split("/"):
                leaf = leaf[key]
            if "value" in want:
                if leaf != want["value"] or type(leaf) is not type(
                        want["value"]):
                    raise AssertionError(f"{name}:{path}: {leaf!r}, want "
                                         f"{want['value']!r}")
                continue
            if isinstance(leaf, torch.Tensor):
                dtype, raw = str(leaf.dtype).split(".")[-1], \
                    leaf.view(torch.int16).numpy()
                values = leaf.float().numpy()
            else:
                leaf = np.asarray(leaf)
                dtype, raw, values = leaf.dtype.name, leaf, leaf
            got = {"shape": list(values.shape), "dtype": dtype,
                   "sha256": hashlib.sha256(
                       np.ascontiguousarray(raw).tobytes()).hexdigest()}
            total = float(values.astype(np.float64).sum())
            if got != {k: want[k] for k in got} or abs(
                    total - want["sum"]) > 1e-12 * max(1.0, abs(want["sum"])):
                raise AssertionError(f"{name}:{path}: {got} sum {total}, "
                                     f"want {want}")
        checked[name] = len(leaves)
    return checked


def block_yaml(config: dict) -> str:
    """``config`` as ``yaml.safe_dump`` lays it out (sorted keys, lists
    as block sequences), for a checkpoint directory the JAX package would
    write; scalars as JSON, which YAML reads the same."""
    out = []
    for k in sorted(config):
        v = config[k]
        if isinstance(v, (list, tuple)):
            out.append(f"{k}:\n" + "".join(f"- {json.dumps(x)}\n" for x in v))
        else:
            out.append(f"{k}: {json.dumps(v)}\n")
    return "".join(out)


def write_jax_layout(state: dict, mapping: dict, path: str) -> int:
    """A port ``state_dict`` as the JAX package's ``.msgpack`` variable
    tree (flax layouts through ``weights.torch_to_jax_leaves``, packed as
    flax packs it). Returns the file's bytes."""
    from fgt_tpu_torch.convert import weights
    from fgt_tpu_torch.utils import checkpoint

    tree: dict = {}
    for fpath, arr in weights.torch_to_jax_leaves(state, mapping).items():
        node = tree
        for key in fpath[:-1]:
            node = node.setdefault(key, {})
        node[fpath[-1]] = np.ascontiguousarray(arr, np.float32)
    checkpoint.save_pytree(tree, path)
    return os.path.getsize(path)


def phase_checkpoints(counters, root: str, smi: str) -> dict:
    """The JAX package's checkpoints and ``result.mp4`` (ROADMAP A.4, A.5):
    the committed flax fixtures against their manifest; the object-removal
    models (full width, seeded as ``phase_main_path`` seeds them) written
    as JAX-layout directories (``lafc.msgpack`` / ``fgt.msgpack`` beside a
    block-style ``config.yaml`` carrying a list, ``raft.msgpack``) and as
    ``.pth``; the full-width FGT's load time from each; the CLI on the
    24-frame 432x240 clip on the K1 path from each (cuDNN deterministic):
    outputs bit-equal, K1 20 and K2 4 launches; the run's ``result.mp4``
    read back (planes equal to ``result.npy``'s, RGB PSNR, bytes) and
    ``s7_write`` with and without it; then the demo with no arguments
    (a readable 12-frame ``result.mp4``)."""
    import torch
    from fgt_tpu_torch.convert import weights
    from fgt_tpu_torch.core import video_io
    from fgt_tpu_torch.pipeline import image_io
    from fgt_tpu_torch.pipeline import video_inpainting as vi
    from fgt_tpu_torch.tools import demo
    from fgt_tpu_torch.utils import checkpoint

    t_phase = time.perf_counter()
    checked = check_msgpack_fixtures()
    log(f"checkpoints: committed flax fixtures read and equal to their "
        f"manifest: {checked} leaves")

    models = vi.Models("cpu", bf16=False, seed=0)     # phase_main_path's
    lafc_cfg = dict(vi.DEFAULT_LAFC_CONFIG, input_resolution=[240, 432])
    fgt_cfg = dict(vi.DEFAULT_FGT_CONFIG, input_resolution=[240, 432],
                   kernel_size=[7, 7])
    sizes = {}
    for kind, module, cfg, mapping in (
            ("lafc", models.lafc, lafc_cfg, weights.lafc_mapping(1)),
            ("fgt", models.fgt, fgt_cfg, weights.fgt_mapping(8))):
        for sub in (kind, f"{kind}_pth"):
            os.makedirs(f"{root}/ck/{sub}")
            with open(f"{root}/ck/{sub}/config.yaml", "w") as f:
                f.write(block_yaml(cfg))
        sizes[kind] = write_jax_layout(module.state_dict(), mapping,
                                       f"{root}/ck/{kind}/{kind}.msgpack")
        checkpoint.save(module.state_dict(), f"{root}/ck/{kind}_pth/model.pth")
    sizes["raft"] = write_jax_layout(models.raft.state_dict(),
                                     weights.raft_mapping(),
                                     f"{root}/ck/raft.msgpack")
    checkpoint.save(models.raft.state_dict(), f"{root}/ck/raft.pth")
    del models
    read_cfg = vi._load_ckpt_dir(f"{root}/ck/fgt", vi.DEFAULT_FGT_CONFIG)[0]
    if read_cfg["input_resolution"] != [240, 432]:
        raise AssertionError(f"config.yaml's list read as "
                             f"{read_cfg['input_resolution']}")
    load_s = {"msgpack": [], "pth": []}
    for _ in range(3):
        for fmt, load in (
                ("msgpack", lambda: weights.load_weights(
                    f"{root}/ck/fgt/fgt.msgpack", "fgt", read_cfg)),
                ("pth", lambda: checkpoint.load_state_dict(
                    f"{root}/ck/fgt_pth/model.pth"))):
            t0 = time.perf_counter()
            state = load()
            load_s[fmt].append(time.perf_counter() - t0)
    mib = sum(v.numel() * 4 for v in state.values()) / 2 ** 20
    log(f"checkpoints: full-width FGT ({mib:.1f} MiB f32; msgpack files "
        + ", ".join(f"{k} {v / 2 ** 20:.1f} MiB" for k, v in sizes.items())
        + ") loaded in " + "; ".join(
            f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " s"
            for k, v in load_s.items()) + f"; {smi}")

    frames, masks = synthetic_video()
    np.save(f"{root}/ck/frames.npy", frames)
    np.save(f"{root}/ck/masks.npy", masks)
    outs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for fmt, lafc, fgt, raft in (
                ("msgpack", "lafc", "fgt", "raft.msgpack"),
                ("pth", "lafc_pth", "fgt_pth", "raft.pth")):
            outs[fmt], _, _ = run_cli(f"checkpoints ({fmt})", counters, [
                "--path", f"{root}/ck/frames.npy", "--path_mask",
                f"{root}/ck/masks.npy", "--outroot", f"{root}/ck/out_{fmt}",
                "--lafc_ckpts", f"{root}/ck/{lafc}", "--fgt_ckpts",
                f"{root}/ck/{fgt}", "--raft_model", f"{root}/ck/{raft}"],
                {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0,
                 "flash_mhsa": 4})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if not np.array_equal(outs["msgpack"], outs["pth"]):
        raise AssertionError("the run from JAX-layout msgpack directories "
                             "differs from the run from .pth")
    out = outs["msgpack"]
    keep = masks == 0
    if out.shape != frames.shape or not np.array_equal(out[keep],
                                                       frames[keep]):
        raise AssertionError("checkpoints run: output wrong outside the hole")
    log("checkpoints: the CLI from JAX-layout msgpack directories is "
        "bit-equal to the run from .pth")

    mp4 = f"{root}/ck/out_msgpack/result.mp4"
    planes = video_io.read_planes(mp4)
    if len(planes) != len(out) or not all(
            np.array_equal(a, b) for fr, pl in zip(out, planes)
            for a, b in zip(pl, video_io.rgb_to_yuv420(fr))):
        raise AssertionError("result.mp4's planes differ from result.npy's")
    rgb = np.stack(video_io.read_video(mp4)).astype(np.float64)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((rgb - out) ** 2))
    with open(f"{root}/ck/out_msgpack/timings.json") as f:
        s7 = json.load(f)["stages"]["s7_write"]
    write_s = {"png_npy": [], "mp4": []}
    for _ in range(3):
        t0 = time.perf_counter()
        image_io.write_frames(f"{root}/ck/s7", out)
        t1 = time.perf_counter()
        video_io.write_video(f"{root}/ck/s7/result.mp4", out, fps=30)
        write_s["png_npy"].append(t1 - t0)
        write_s["mp4"].append(time.perf_counter() - t1)
    log(f"result.mp4: {os.path.getsize(mp4)} bytes for {len(out)} frames "
        f"{out.shape[2]}x{out.shape[1]}, Y/Cb/Cr planes equal to "
        f"result.npy's, RGB PSNR {psnr:.3f} dB against result.npy; s7_write "
        f"{s7:.4f} s in the run (npy + PNGs + MP4); alone: npy + PNGs "
        + " / ".join(f"{t:.4f}" for t in write_s["png_npy"]) + " s, MP4 "
        + " / ".join(f"{t:.4f}" for t in write_s["mp4"]) + f" s; {smi}")

    cwd = os.getcwd()
    os.makedirs(f"{root}/demo")
    os.chdir(f"{root}/demo")
    try:
        reset(counters)
        t0 = time.perf_counter()
        path = demo.main([])
        torch.cuda.synchronize()
        demo_s = time.perf_counter() - t0
        launches = read(counters)
        path = os.path.abspath(path)
        result = np.load(os.path.join(os.path.dirname(path), "result.npy"))
    finally:
        os.chdir(cwd)
    shown = video_io.read_video(path)
    planes = video_io.read_planes(path)
    if len(shown) != 12 or shown[0].shape != (240, 432, 3) or not all(
            np.array_equal(a, b) for fr, pl in zip(result, planes)
            for a, b in zip(pl, video_io.rgb_to_yuv420(fr))):
        raise AssertionError(f"demo: {path} holds {len(shown)} frames, "
                             f"want 12 of result.npy's planes")
    expect_launches("demo", launches, {"lookup_corr_fused": 20,
                                       "flash_mhsa": None})
    log(f"demo (python -m fgt_tpu_torch.tools.demo, no arguments): "
        f"{demo_s:.2f} s wall (scene written, models built, 12 frames "
        f"inpainted, result.mp4 written); {path} readable, 12 frames; "
        f"launches {launches}; {smi}")
    log(f"checkpoints and MP4 phase: {time.perf_counter() - t_phase:.2f} s")
    return {"load_s": load_s, "s7": s7, "write_s": write_s, "psnr": psnr,
            "mp4_bytes": os.path.getsize(mp4), "demo_s": demo_s}


def warm_spectral(module, iters: int = 3) -> None:
    """``iters`` power iterations on every spectral-norm conv's u, v, in
    f64 on the host, so two devices get the same vectors. The init's
    random pair can make sigma = u·W·v nearly cancel; a card-vs-CPU
    comparison would then measure that cancellation (with the random
    pair an H100's output and the CPU's differed by 4.9 levels on
    average under SN)."""
    import torch
    from fgt_tpu_torch.ops.conv_blocks import SNConv

    for m in module.modules():
        if isinstance(m, SNConv):
            w = m.weight_orig.detach().cpu().double()
            mat = w.reshape(w.shape[0], -1)
            u = m.weight_u.cpu().double()
            for _ in range(iters):
                v = mat.t() @ u
                v = v / (v.norm() + 1e-12)
                u = mat @ v
                u = u / (u.norm() + 1e-12)
            with torch.no_grad():
                m.weight_u.copy_(u.to(m.weight_u))
                m.weight_v.copy_(v.to(m.weight_v))


def phase_small_reference(corr: str = "fused", use_nonlocal: bool = False,
                          small: bool = False, conv_type: str = "vanilla",
                          norm=None):
    """6 frames at 64x64, full-width RAFT (big, or small) and LAFC, FGT at
    512 hidden / 4 heads (head dim 128 for K2) with 2 blocks, f32: the
    port on the card (kernels) against the port on the CPU (plain
    versions), on the ``corr`` path of s1 (and with --Nonlocal), LAFC and
    FGT in ``conv_type`` (FGT's flow encoder and decoder also in
    ``norm``; SN's u, v power-iterated, :func:`warm_spectral`). Outside
    the hole the bytes
    must match; inside, flowNN's thresholded decisions can amplify f32
    reassociation, so the bound is on the mean."""
    import torch
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    fgt_cfg = dict(vi.DEFAULT_FGT_CONFIG, numBlocks=2, mlp_ratio=4,
                   res_h=64, res_w=64, conv_type=conv_type, norm=norm)
    lafc_cfg = dict(vi.DEFAULT_LAFC_CONFIG, conv_type=conv_type)
    frames, masks = synthetic_video(n=6, h=64, w=64, hole=16, y0=24, x0=16)
    outs = []
    for dev in ("cuda", "cpu"):
        models = vi.Models(dev, bf16=False, raft_iters=4, fgt_config=fgt_cfg,
                           lafc_config=lafc_cfg, seed=3, corr=corr,
                           small=small)
        warm_spectral(models.fgt)
        outs.append(vi.inpaint(frames, masks, models, flow_mask_dilates=2,
                               neighbor_stride=3, step=4,
                               use_nonlocal=use_nonlocal))
    gpu, cpu = (o.astype(np.int64) for o in outs)
    hole = masks > 0
    d = np.abs(gpu - cpu)[hole]
    log(f"small reference ({corr}{', --Nonlocal' if use_nonlocal else ''}"
        f"{', --small' if small else ''}"
        f"{f', {conv_type} norm {norm}' if conv_type != 'vanilla' else ''}"
        "): "
        f"card vs CPU byte-equal: {np.array_equal(gpu, cpu)}; inside the "
        f"hole: mean |diff| {d.mean():.4f}, max {d.max()}, share > 8 levels "
        f"{(d > 8).mean():.4f}")
    if not np.array_equal(gpu[~hole], cpu[~hole]) or d.mean() > 1.0:
        raise AssertionError("card and CPU runs of the port disagree")
    del models
    torch.cuda.empty_cache()


TRAIN_STEPS = 10      # timed steps of each training run, after 2 cold ones


CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def committed_config(name: str) -> dict:
    """``configs/<name>.yaml`` through the port's own YAML reader (the GPU
    machine has no PyYAML), with the training CLI's derived tuples."""
    from fgt_tpu_torch.utils.config import derive_model_tuples, read_yaml

    return derive_model_tuples(read_yaml(os.path.join(CONFIGS,
                                                      f"{name}.yaml")))


def lafc_opt(root: str, single: bool, **kw) -> dict:
    """configs/lafc_train.yaml (``single``: lafc_single_train.yaml) as
    committed (cnum 48, resBlocks 1, bf16 mixed precision, the
    global-norm clip ``gc`` for LAFC only, the reference optimizer
    recipe), without its dataset (the phase feeds its batch), writing
    under ``root``, logging every step for the per-step losses."""
    opt = committed_config("lafc_single_train" if single else "lafc_train")
    del opt["datasets"]
    opt.update(outputdir=root, record_iter=1)
    opt["train"].update(MAX_ITERS=0, log_freq=1,
                        save_checkpoint_freq=10 ** 9)
    opt.update(kw)
    return opt


def lafc_train_batch(b=4, t=3, h=256, w=256, seed=0, device="cuda"):
    """A stage-1 batch made on the card: per sample, a smooth flow field
    (``smooth_coords``' recipe, 4 px) plus 3 blocks of 64x72 (at 256x256)
    moving 8 px against it, 120 degrees apart on the colour wheel (motion
    boundaries, so the Canny targets are not empty), and drifting 1 px a
    frame; a 64x80 hole moving 6 px a frame;
    ``diffused_flows`` from the port's ``ops/diffusion`` (the stand-in
    for the dataset's host regionfill); ``edges`` from
    ``core/edge.flow_edge`` of the pivot flow (host); a smoothed-noise
    shift frame and the current frame warped from it by the pivot
    flow."""
    import torch
    import torch.nn.functional as F
    from fgt_tpu_torch.core.edge import flow_edge
    from fgt_tpu_torch.core.warp import image_warp
    from fgt_tpu_torch.ops.diffusion import diffuse_flows_device

    gen = torch.Generator(device).manual_seed(seed)
    rng = np.random.RandomState(seed)
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    grid = torch.stack([xs, ys], -1).float()
    bh, bw = h // 4, w * 9 // 32                 # block
    hh, hw, step = h // 4, w * 5 // 16, max(1, w // 40)   # hole
    flows = torch.empty(b, t, h, w, 2, device=device)
    masks = torch.zeros(b, t, h, w, 1, device=device)
    for i in range(b):
        field = smooth_coords(1, h, w, gen, amp=4.0)[0] - grid
        corners = list(zip(rng.randint(0, h - bh - t, 3),
                           rng.randint(0, w - bw - t, 3)))
        angles = rng.uniform(0, 2 * np.pi) + np.arange(3) * 2 * np.pi / 3
        moves = (8 * np.stack([np.cos(angles), np.sin(angles)], -1)) \
            .astype(np.float32)
        y0, x0 = rng.randint(0, h - hh + 1), rng.randint(0, w - hw - step * t)
        for j in range(t):
            flows[i, j] = field
            for (by, bx), mv in zip(corners, moves):
                flows[i, j, by + j:by + j + bh, bx + j:bx + j + bw] = \
                    torch.from_numpy(mv).to(device)
            masks[i, j, y0:y0 + hh, x0 + step * j:x0 + step * j + hw] = 1.0
    diffused = torch.stack([diffuse_flows_device(flows[i], masks[i])
                            for i in range(b)])
    pivot = flows[:, t // 2]
    edges = np.stack([flow_edge(f)[1] for f in pivot.cpu().numpy()])
    noise = torch.rand(b, 3, h + 8, w + 8, device=device, generator=gen)
    shift = F.avg_pool2d(noise, 9, stride=1)[:, :, :h, :w] \
        .permute(0, 2, 3, 1).contiguous()
    shift = (shift - shift.amin()) / (shift.amax() - shift.amin())
    return {"flows": flows, "diffused_flows": diffused, "masks": masks,
            "edges": torch.from_numpy(edges[..., None]).float().to(device),
            "current_frame": image_warp(shift, pivot),
            "shift_frame": shift}


def conv_tflop(model, *inputs) -> float:
    """TFLOP of a training step's convolutions: 3 x the forward's
    (forward, input and weight gradients), 2 per multiply-add, counted
    from each convolution's output shape on these inputs."""
    import torch

    macs = [0]

    def hook(m, _, out):
        macs[0] += out.numel() * m.in_channels // m.groups * int(
            np.prod(m.kernel_size))

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    with torch.no_grad():
        model(*inputs)
    for h in hooks:
        h.remove()
    return 3 * 2 * macs[0] / 1e12


LAFC_METRICS = ("loss", "l1_masked", "l1_valid", "sm1", "sm2", "ternary",
                "edge")


def train_lafc(counters, root: str, single: bool, smi: str) -> dict:
    """One stage-1 model through ``LAFCTrainer`` at full width (see the
    module doc). Returns its numbers and the paths of its last
    checkpoint and ``latest`` directory."""
    import torch
    from fgt_tpu_torch.train.trainer import LAFCTrainer

    label = "LAFC-single" if single else "LAFC"
    opt = lafc_opt(root, single)
    batch = lafc_train_batch()
    if single:                 # 4-D single-flow items, lifted to T = 1
        for k in ("flows", "diffused_flows", "masks"):
            batch[k] = batch[k][:, 1]
    log(f"{label} batch: " + ", ".join(
        f"{k} {list(v.shape)}" for k, v in batch.items())
        + f"; edge pixels {batch['edges'].mean().item():.4f}, hole share "
        f"{batch['masks'].mean().item():.4f}")
    if not batch["edges"].amax(dim=(1, 2, 3)).all():
        raise AssertionError(f"{label}: a sample has no edge target")
    reset(counters)
    t0 = time.perf_counter()
    trainer = LAFCTrainer(opt)
    n_par = sum(p.numel() for p in trainer.model.parameters())
    tflop = conv_tflop(trainer.model, batch["diffused_flows"],
                       batch["masks"])
    log(f"{label}: trainer built in {time.perf_counter() - t0:.2f} s; "
        f"{n_par / 1e6:.3f} M parameters; {tflop:.4f} TFLOP of "
        f"convolutions a step")

    trainer.total_iterations = 2                 # cold steps
    t0 = time.perf_counter()
    trainer.train([batch])
    torch.cuda.synchronize()
    log(f"{label}: 2 cold steps (+ final checkpoint) in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    trainer.total_iterations = 2 + TRAIN_STEPS
    t0 = time.perf_counter()
    trainer.train([batch])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = read_metrics(trainer, 2)
    steps_per_s = (len(rows) - 1) / (rows[-1]["time"] - rows[0]["time"])
    log(f"{label} train: {TRAIN_STEPS} steps, {steps_per_s:.4f} "
        f"steps/s ({1e3 / steps_per_s:.3f} ms/step, "
        f"{tflop * steps_per_s:.2f} TFLOP/s of convolutions; wall "
        f"{wall:.2f} s with the final checkpoint); peak device memory "
        f"{peak:.3f} GiB; {smi}")
    for r in rows:
        log(f"{label} step " + json.dumps(
            {k: round(r[k], 6) for k in ("step", "lr") + LAFC_METRICS}))
    if not all(np.isfinite(r[k]) for r in rows for k in LAFC_METRICS):
        raise AssertionError(f"{label}: a loss term is not finite")
    total = [r["loss"] for r in rows]
    if not np.mean(total[-3:]) < total[0]:
        raise AssertionError(f"{label}: the total loss did not fall: {total}")

    # resume: save the pair, 3 steps, reload into a new trainer, 3 steps;
    # deterministic algorithms (cuDNN's too), so the two runs are bit-equal
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        paths = trainer.save_checkpoint(0)
        start = trainer.current_step
        trainer.total_iterations = start + 3
        trainer.train([batch])
        want = [r["loss"] for r in read_metrics(trainer, start)]
        resumed = LAFCTrainer(dict(opt, path=paths, resume=True))
        if resumed.current_step != start or resumed.lafc_step.step != start:
            raise AssertionError(f"{label}: resume did not restore the step")
        resumed.total_iterations = start + 3
        resumed.train([batch])
        got = [r["loss"] for r in read_metrics(resumed, start)][-3:]
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    log(f"{label} resume: loss {want} (continued) vs {got} (resumed)")
    if got != want:
        raise AssertionError(f"{label}: the resumed run differs")
    for a, b in zip(trainer.model.state_dict().values(),
                    resumed.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: resumed weights differ")
    launches = read(counters)
    log(f"{label}: kernel launches during the phase {launches}")
    if any(launches.values()):
        raise AssertionError(f"{label}: stage-1 training launched a kernel")
    final = resumed.save_checkpoint(1)
    stats = dict(steps_per_s=steps_per_s, peak_gib=peak, tflop=tflop,
                 gen_state=final["gen_state"],
                 latest=os.path.join(resumed.run_dir, "latest"))
    del trainer, resumed
    torch.cuda.empty_cache()
    return stats


def phase_lafc_train(kernels, inference_counters, root: str, smi: str):
    """Stage 1 at full width, both models, then the chain: the LAFC
    trainer's ``latest`` directory is ``--lafc_ckpts`` of a 6-frame
    object-removal run. Returns the LAFC-single trainer's checkpoint,
    stage 2's flow oracle."""
    stats = {single: train_lafc(kernels, root, single, smi)
             for single in (False, True)}
    frames, masks = synthetic_video(n=6)
    np.save(f"{root}/s1_frames.npy", frames)
    np.save(f"{root}/s1_masks.npy", masks)
    out, _, _ = run_cli("6 frames with the trained LAFC", inference_counters,
                        ["--path", f"{root}/s1_frames.npy", "--path_mask",
                         f"{root}/s1_masks.npy", "--outroot",
                         f"{root}/s1_out", "--lafc_ckpts",
                         stats[False]["latest"]],
                        {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0,
                         "flash_mhsa": None})
    hole = masks > 0
    if out.shape != frames.shape or not np.array_equal(out[~hole],
                                                       frames[~hole]):
        raise AssertionError("trained-LAFC run: output wrong outside the "
                             "hole")
    log(f"stage 1 -> inference: the LAFC trainer's latest directory as "
        f"--lafc_ckpts: output ok")
    return stats[True]["gen_state"], stats


def phase_small_lafc_train():
    """One SGD LAFC step (cnum 48, resBlocks 1, gc) on 1 x 3 flows at
    64x64, on the card and on the CPU from the same weights and batch, in
    f64. SGD with lr 1 makes each parameter delta the negative (clipped)
    gradient. Loss terms must agree to 1e-9 relative, every tensor's
    delta to 1e-7 of its own largest |delta| plus 1e-9 of the model's
    largest. Not in f32: on the card's batch the f32 step on either
    device left the f64 one by more than the GAN step's tolerance (1e-3
    of a tensor's largest delta plus 1e-5 of the model's; PERF.md, PR 8),
    so the f32 steps are printed against the f64 one, unchecked."""
    import torch
    from fgt_tpu_torch.models import lafc
    from fgt_tpu_torch.train.lafc_step import LAFCTrainStep

    batch = {k: v.cpu().double() for k, v in
             lafc_train_batch(b=1, h=64, w=64, seed=2).items()}
    cfg = lafc_opt(".", False)
    results = {}
    for dev, dt in (("cuda", torch.float64), ("cpu", torch.float64),
                    ("cuda", torch.float32), ("cpu", torch.float32)):
        model = lafc.init_lafc(lafc.Model(cfg),
                               torch.Generator().manual_seed(5)).to(dev, dt)
        before = {k: p.detach().cpu().double().clone()
                  for k, p in model.named_parameters()}
        step = LAFCTrainStep(model, torch.optim.SGD(model.parameters(),
                                                    lr=1.0), grad_clip=10.0)
        metrics = step({k: v.to(dev, dt) for k, v in batch.items()})
        deltas = {k: p.detach().cpu().double() - before[k]
                  for k, p in model.named_parameters()}
        results[dev, dt] = ({k: float(v) for k, v in metrics.items()},
                            deltas)

    def compare(got, want, own, model):
        """(max rel loss err, worst delta err / tol, at which tensor)"""
        (m_got, d_got), (m_want, d_want) = got, want
        loss_err = max(abs(m_got[k] - m_want[k]) / max(abs(m_want[k]), 1e-12)
                       for k in m_want)
        top = max(v.abs().max().item() for v in d_want.values())
        worst = max(((d_got[k] - w).abs().max().item()
                     / (own * w.abs().max().item() + model * top), k)
                    for k, w in d_want.items())
        return loss_err, worst[0], worst[1]

    ref = results["cpu", torch.float64]
    loss_err, worst, key = compare(results["cuda", torch.float64], ref,
                                   1e-7, 1e-9)
    log(f"small LAFC step (f64): card vs CPU loss terms max rel err "
        f"{loss_err:.3g} (tol 1e-9); parameter deltas worst err/tol "
        f"{worst:.3g} at {key}; loss "
        f"{results['cuda', torch.float64][0]['loss']:.12f} vs "
        f"{ref[0]['loss']:.12f}")
    for dev in ("cuda", "cpu"):
        e32 = compare(results[dev, torch.float32], ref, 1e-3, 1e-5)
        log(f"small LAFC step (f32 on {dev}) vs the f64 CPU step: loss "
            f"terms max rel err {e32[0]:.3g}; parameter deltas worst "
            f"err / (1e-3 own max + 1e-5 model max) {e32[1]:.3g} at {e32[2]}")
    if not (loss_err <= 1e-9 and worst <= 1.0):
        raise AssertionError("card and CPU LAFC steps disagree")


def train_opt(root: str, **kw) -> dict:
    """configs/fgt_train.yaml as committed (the full-width generator,
    T-PatchGAN with dist_cnum 32, bf16 mixed precision, the oracle's
    LAFC-single config, the reference optimizer recipe), without its
    dataset (the phase feeds its batch), writing under ``root``, logging
    every step for the per-step losses."""
    opt = committed_config("fgt_train")
    del opt["datasets"]
    opt.update(outputdir=root, record_iter=1)
    opt["train"].update(MAX_ITERS=0, log_freq=1,
                        save_checkpoint_freq=10 ** 9)
    opt.update(kw)
    return opt


def synthetic_train_batch(b=2, t=5, h=240, w=432, seed=0):
    """bench_train.py's synth_fgt_batch: one random image repeated over
    the frames plus 5% noise, a 72x96 hole, random flows."""
    rng = np.random.RandomState(seed)
    base = rng.rand(1, 1, h, w, 3).astype(np.float32)
    frames = np.broadcast_to(base, (b, t, h, w, 3)).copy() * 2 - 1
    frames += rng.randn(b, t, h, w, 3).astype(np.float32) * 0.05
    masks = np.zeros((b, t, h, w, 1), np.float32)
    masks[:, :, h // 3: h // 3 + 72, w // 3: w // 3 + 96] = 1.0
    flows = rng.randn(b, t, h, w, 2).astype(np.float32)
    return {"frames": frames.astype(np.float32), "masks": masks,
            "forward_flo": flows}


def read_metrics(trainer, first_step: int) -> list:
    with open(trainer.metrics.path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if r["step"] > first_step]


def phase_train(counters, profile: bool, oracle: str):
    """Full-width FGT GAN training on the card (see the module doc), with
    ``oracle`` (the LAFC-single trainer's state dict) as the frozen flow
    oracle."""
    import torch
    from fgt_tpu_torch.ops.attention import TMHSA
    from fgt_tpu_torch.train.trainer import FGTTrainer

    with tempfile.TemporaryDirectory() as root:
        opt = train_opt(root, flow_checkPoint=oracle)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in synthetic_train_batch().items()}
        t0 = time.perf_counter()
        trainer = FGTTrainer(opt)
        torch.cuda.synchronize()
        n_gen = sum(p.numel() for p in trainer.gen.parameters())
        log(f"train: trainer built in {time.perf_counter() - t0:.2f} s; "
            f"generator {n_gen / 1e6:.2f} M parameters")

        trainer.total_iterations = 2                 # cold steps
        t0 = time.perf_counter()
        trainer.train([batch])
        torch.cuda.synchronize()
        log(f"train: 2 cold steps (+ final checkpoint) in "
            f"{time.perf_counter() - t0:.2f} s")

        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.total_iterations = 2 + TRAIN_STEPS
        t0 = time.perf_counter()
        trainer.train([batch])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows = read_metrics(trainer, 2)
        # steps/s between the first and last step's log stamps (each log
        # syncs the card); the wall also holds the final checkpoint save
        steps_per_s = (len(rows) - 1) / (rows[-1]["time"] - rows[0]["time"])
        per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
        log(f"train: {TRAIN_STEPS} steps, {steps_per_s:.4f} steps/s "
            f"({1 / steps_per_s:.4f} s/step; wall {wall:.2f} s with the "
            f"final checkpoint); peak device memory {peak:.2f} GiB; "
            f"launches per step {per_step}")
        for r in rows:
            log("train step " + json.dumps(
                {k: round(r[k], 6) for k in ("step", "gen_loss", "dis_loss",
                                             "adv", "l1_valid", "l1_masked",
                                             "lr")}))
        if any(v != 4 for v in per_step.values()):
            raise AssertionError(f"expected 4 launches per step: {per_step}")
        keys = ("gen_loss", "dis_loss", "dis_real", "dis_fake", "adv",
                "l1_valid", "l1_masked")
        if not all(np.isfinite(r[k]) for r in rows for k in keys):
            raise AssertionError("a loss is not finite")
        l1 = [r["l1_valid"] + r["l1_masked"] for r in rows]
        if not np.mean(l1[-3:]) < l1[0]:
            raise AssertionError(f"l1 did not fall: {l1}")
        n_emb = 0
        for m in trainer.gen.modules():
            if isinstance(m, TMHSA):
                for lin in (m.query_embedding, m.key_embedding,
                            m.value_embedding):
                    gw = lin.weight.grad
                    if gw is None or not torch.isfinite(gw).all() or \
                            gw.abs().max().item() == 0:
                        raise AssertionError("a TMHSA embedding got no "
                                             "finite nonzero gradient")
                    n_emb += 1
        log(f"train: l1 {l1[0]:.4f} -> {l1[-1]:.4f}; {n_emb} TMHSA q/k/v "
            f"embedding weights with finite nonzero gradients")

        if profile:
            profile_steps(trainer, batch)

        # resume: save the trio, 3 steps, reload into a new trainer, 3 steps
        paths = trainer.save_checkpoint(0)
        start = trainer.current_step
        trainer.total_iterations = start + 3
        trainer.train([batch])
        want = [r["gen_loss"] for r in read_metrics(trainer, start)]
        del trainer
        torch.cuda.empty_cache()
        resumed = FGTTrainer(dict(opt, path=paths, resume=True))
        if resumed.current_step != start:
            raise AssertionError("resume did not restore the step")
        resumed.total_iterations = start + 3
        resumed.train([batch])
        got = [r["gen_loss"] for r in read_metrics(resumed, start)][-3:]
        log(f"train resume: gen_loss {want} (continued) vs {got} (resumed)")
        if not np.allclose(got, want, rtol=1e-4, atol=0):
            raise AssertionError("resumed run differs")
        del resumed
        torch.cuda.empty_cache()
    return launches, dict(steps_per_s=steps_per_s, peak_gib=peak)


# ---------------- training from disk through the CLI ----------------

CLI_STEPS = 12          # 2 cold + 10 timed steps of each CLI run
LOADER_ITEMS = 8        # items the loader's own rate is taken over


def smooth_field(h: int, w: int, rng, amp: float) -> np.ndarray:
    """A smooth [h, w, 2] float32 field: two random sinusoids a channel."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    out = np.zeros((h, w, 2))
    for c in range(2):
        for _ in range(2):
            fy, fx, ph = rng.uniform(0.5, 2.0), rng.uniform(0.5, 2.0), \
                rng.uniform(0, 2 * np.pi)
            out[..., c] += amp / 2 * np.sin(2 * np.pi * (fy * yy / h
                                                         + fx * xx / w) + ph)
    return out.astype(np.float32)


def write_video_tree(root: str, videos: int, frames: int, frame_hw,
                     flow_hw, seed: int, masks: bool = False,
                     fmt: str = "png") -> dict:
    """A YouTube-VOS / DAVIS-style tree from a seed: ``frames/<v>/*.png``
    (smoothed noise panning 2 px a frame; with ``fmt`` "jpg" the same
    pixels as ``*.jpg``, baseline 4:2:0 q90, as both datasets ship
    them), ``flows/<v>/{forward,
    backward}_flo/*.flo`` (a smooth 4 px field plus 3 blocks moving 8 px
    against it, 120 degrees apart on the colour wheel, drifting 1 px a
    frame, so the Canny targets are not empty) and, with ``masks``,
    ``masks/<v>/*.png`` (a moving box). Returns the three roots."""
    from fgt_tpu_torch.core.flow_io import write_flow
    from fgt_tpu_torch.pipeline.image_io import resize_linear_u8, write_png

    rng = np.random.RandomState(seed)
    (fh, fw), (gh, gw) = frame_hw, flow_hw
    roots = {k: os.path.join(root, k) for k in ("frames", "flows", "masks")}
    bh, bw = gh // 4, gw * 9 // 32
    for v in range(videos):
        name = f"video_{v:02d}"
        for k in ("frames", "masks") if masks else ("frames",):
            os.makedirs(os.path.join(roots[k], name))
        low = (rng.rand(fh // 8 + 8, fw // 8 + 8 + frames, 3) * 255).astype(
            np.uint8)
        big = resize_linear_u8(low, (fh // 8 + 8) * 8,
                               (fw // 8 + 8 + frames) * 8)
        clip = np.stack([big[32:32 + fh, 32 + 2 * i:32 + 2 * i + fw]
                         for i in range(frames)])
        (write_jpegs if fmt == "jpg" else write_pngs)(
            os.path.join(roots["frames"], name), clip)
        for i in range(frames):
            if masks:
                m = np.zeros((fh, fw), np.uint8)
                m[fh // 3:fh // 3 + fh // 4,
                  fw // 3 + 2 * i:fw // 3 + 2 * i + fw // 5] = 255
                write_png(os.path.join(roots["masks"], name,
                                       f"{i:05d}.png"), m)
        for d in ("forward_flo", "backward_flo"):
            out = os.path.join(roots["flows"], name, d)
            os.makedirs(out)
            field = smooth_field(gh, gw, rng, 4.0)
            corners = list(zip(rng.randint(0, gh - bh - frames, 3),
                               rng.randint(0, gw - bw - frames, 3)))
            angles = rng.uniform(0, 2 * np.pi) + np.arange(3) * 2 * np.pi / 3
            moves = 8 * np.stack([np.cos(angles), np.sin(angles)], -1)
            for i in range(frames - 1):
                flow = field.copy()
                for (by, bx), mv in zip(corners, moves):
                    flow[by + i:by + i + bh, bx + i:bx + i + bw] = mv
                write_flow(flow, os.path.join(out, f"{i:05d}.flo"))
    return roots


SUSTAINED_STEPS = 48      # logs at 16, 32, 48: the LR boundary (24) seen
SUSTAINED_VAL_EVERY = 16  # two validations (at 16 and 32)


def phase_sustained_train(kernels, smi: str) -> dict:
    """The sustained-training tool through its ``main`` at the JAX tool's
    protocol (240x432, 5 frames, batch 2, bf16, the committed model
    scale), cut to 4 videos x 12 frames and 48 steps (the defaults: 8 x
    26 frames, 5000 steps), with the committed configs' 4 loader workers
    (with the tool's default 2 the phase took 126 s on an H100 machine,
    waiting on the loader): the LR
    must have decayed mid-run, each validation's val/* be finite, every
    loss finite, the checkpoint trio written, and the launches, reset
    just before and read just after, K2 4 a step plus 4 videos x its
    temporal blocks a validation, K4 and K5 4 a step, K1 and K3 none.
    Runs under PyTorch's default TF32 settings, as the tool runs on its
    own (with cuDNN's TF32 off its validation peaks at ~20 GiB).
    ``kernels``: the K1-K5 counters."""
    import contextlib
    import io

    import torch
    from fgt_tpu_torch.tools import sustained_train

    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory() as root:
            argv = ["--videos", "4", "--frames", "12", "--steps",
                    str(SUSTAINED_STEPS), "--val_every_steps",
                    str(SUSTAINED_VAL_EVERY), "--workers", "4", "--root",
                    root]
            printed = io.StringIO()
            reset(kernels)
            with contextlib.redirect_stdout(printed):
                rec = sustained_train.main(argv)
            launches = read(kernels)
            torch.cuda.synchronize()
            files = sorted(os.listdir(root))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    wall = time.perf_counter() - t_phase
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    if line != {k: v for k, v in rec.items() if k != "curves"}:
        raise AssertionError("sustained: the printed line is not the record")
    blocks = 8 // 2                         # numBlocks 8: temporal blocks
    vals = rec["validations"]
    want = {"flash_mhsa": 4 * SUSTAINED_STEPS + len(vals) * 4 * blocks,
            "flash_attention_dq": 4 * SUSTAINED_STEPS,
            "flash_attention_dkv": 4 * SUSTAINED_STEPS,
            "lookup_corr_fused": 0, "lookup_corr_pyramid": 0}
    log(f"sustained training (tools/sustained_train, 240x432, batch 2, "
        f"bf16, 4 videos x 12 JPEG frames, 4 workers, {SUSTAINED_STEPS} "
        f"steps): "
        f"{rec['value']} steps/s over {rec['wall_s']} s (init "
        f"{rec['init_s']} s, trees {rec['datagen_s']} s; phase "
        f"{wall:.2f} s); host data share {rec['host_data_share']} (wait "
        f"{rec['wait_ms']} ms, step {rec['step_ms']} ms); validations "
        f"{json.dumps(vals)} in {rec['validation_s']} s; lr "
        f"{rec['lr_first']} -> {rec['lr_last']}; gen_loss "
        f"{rec['gen_loss_first_mean']} -> {rec['gen_loss_last_mean']}; "
        f"dis_loss (second half) {rec['dis_loss_last_half_min']}.."
        f"{rec['dis_loss_last_half_max']}; peak device memory "
        f"{rec['peak_gib']} GiB; launches {launches}; checkpoints "
        f"{rec['checkpoints']}; {smi}")
    if not rec["lr_decayed"]:
        raise AssertionError(f"sustained: the LR did not decay: "
                             f"{rec['curves']['lr']}")
    if len(vals) != SUSTAINED_STEPS // SUSTAINED_VAL_EVERY - 1 or not all(
            np.isfinite(v[k]) for v in vals
            for k in ("psnr", "ssim", "l1", "l2")):
        raise AssertionError(f"sustained: validations {vals}")
    if not rec["losses_finite"] or \
            rec["curves"]["step"] != list(range(16, SUSTAINED_STEPS + 1, 16)):
        raise AssertionError(f"sustained: losses {rec['curves']}")
    if [c.split("_")[0] for c in rec["checkpoints"]] != ["dist", "gen",
                                                         "opt"]:
        raise AssertionError(f"sustained: checkpoints {rec['checkpoints']}")
    if launches != want or rec["launches"] != {
            k: want[k] for k in rec["launches"]}:
        raise AssertionError(f"sustained: launches {launches} (the tool's "
                             f"{rec['launches']}), want {want}")
    if "sustained_train.json" not in files:
        raise AssertionError(f"sustained: no record under --root: {files}")
    torch.cuda.empty_cache()
    return rec


def cli_config(path: str, name: str, train: dict, val: dict,
               **replace) -> str:
    """A copy of ``configs/<name>.yaml`` at ``path`` with only the data
    paths, ``MAX_ITERS``, ``val_freq``, ``log_freq`` (every step, for the
    per-step losses and time stamps) and the ``valInfo`` block replaced,
    plus ``replace`` (``flow_checkPoint``). Every width, the batch size
    and ``n_workers`` are the committed file's."""
    from fgt_tpu_torch.utils.config import dump_yaml, read_yaml

    cfg = read_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    info = cfg["datasets"]["dataInfo"]
    info.update(frame_path=train["frames"], flow_path=train["flows"])
    cfg["datasets"]["valInfo"] = dict(cfg["datasets"].get("valInfo", {}),
                                      **val)
    cfg["train"].update(MAX_ITERS=CLI_STEPS, log_freq=1,
                        val_freq=replace.pop("val_freq"))
    cfg.update(replace)
    with open(path, "w") as f:
        f.write(dump_yaml(cfg))
    return path


def loader_rate(dataset, batch: int, workers: int, items: int) -> float:
    """Items/s of the port's loader over ``dataset`` alone (no training
    step): ``items`` items in batches of ``batch``; with workers, timed
    after a first batch that starts the pool."""
    from fgt_tpu_torch.data import DataLoader

    order = [i % len(dataset) for i in range(items + batch)]
    with DataLoader(dataset, batch, sampler=order, num_workers=workers,
                    drop_last=True) as loader:
        it = iter(loader)
        next(it)
        t0 = time.perf_counter()
        n = sum(len(next(iter(b.values()))) for b in it)
        return n / (time.perf_counter() - t0)


def step_rate(rows: list) -> float:
    """Steps/s over steps 3..12 from the per-step log stamps, leaving out
    an interval that holds a validation."""
    steps = [r for r in rows if not any(k.startswith("val/") for k in r)]
    vals = [r["time"] for r in rows if any(k.startswith("val/") for k in r)]
    spans = [(a["time"], b["time"]) for a, b in zip(steps[1:], steps[2:])]
    kept = [b - a for a, b in spans if not any(a <= v <= b for v in vals)]
    return len(kept) / sum(kept)


def free_address() -> str:
    """127.0.0.1 and a port nothing listens on: the rendezvous of a
    process group this script makes."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def phase_cli_train(kernels, root: str, smi: str, fmt: str = "png",
                    nccl: bool = False) -> dict:
    """The three training configurations from disk through the training
    CLI (see the module doc), from a tree of ``fmt`` ("png" or "jpg")
    frames; with ``nccl`` each run also takes ``--coordinator
    127.0.0.1:<free port> --num_processes 1 --process_id 0``, so it trains
    in a one-rank NCCL group (checked at every step). ``kernels``: the
    K1-K5 counters."""
    import torch
    from fgt_tpu_torch.ops import flash_attention
    from fgt_tpu_torch.train import train as train_cli
    from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer

    t_phase = time.perf_counter()
    tag = f"{fmt}, one NCCL rank" if nccl else fmt
    train = write_video_tree(os.path.join(root, "train"), 4, 10, (480, 864),
                             (240, 432), seed=20, fmt=fmt)
    val = write_video_tree(os.path.join(root, "val"), 2, 24, (240, 432),
                           (240, 432), seed=21, masks=True, fmt=fmt)
    log(f"cli train ({tag}): trees written in "
        f"{time.perf_counter() - t_phase:.2f} s (train 4 videos x 10 "
        f"{fmt.upper()} frames 480x864 + .flo 240x432; val 2 x 24 at "
        f"240x432 with PNG masks)")
    val_info = {"frame_root": val["frames"], "flow_root": val["flows"],
                "mask_root": val["masks"], "num_videos": 2}
    # one validation each, mid-run: LAFC takes one batch an epoch (4
    # videos, batch 4), FGT two (batch 2); the last epoch ends training
    runs = (("lafc_single", "lafc_single_train", 11, {}),
            ("lafc", "lafc_train", 11, {}),
            ("model", "fgt_train", 5, {"flow_checkPoint": os.path.join(
                root, "outputs", "LAFC_single_train", "latest",
                "model.pth")}))
    # instrumentation around the trainers' methods (restored below): each
    # step's entry and synchronized exit, and each validation's K2
    # launches, seconds and peak memory (the run's peak kept beside it)
    probe = {"steps": [], "vals": [], "groups": set()}
    patched = {(cls, name): getattr(cls, name)
               for cls in (LAFCTrainer, FGTTrainer)
               for name in ("_train_step", "_validate")}

    def timed_step(orig):
        def step(self, batch):
            t0 = time.perf_counter()
            metrics = orig(self, batch)
            torch.cuda.synchronize()
            probe["steps"].append((t0, time.perf_counter()))
            dist = torch.distributed
            probe["groups"].add(
                (dist.get_backend(), dist.get_world_size())
                if dist.is_initialized() else None)
            return metrics
        return step

    def measured_validate(orig):
        def validate(self, epoch):
            before = flash_attention.flash_mhsa.launches
            run_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            orig(self, epoch)
            torch.cuda.synchronize()
            probe["vals"].append(dict(
                k2=flash_attention.flash_mhsa.launches - before,
                s=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated(), run_peak=run_peak))
        return validate

    out = {}
    cwd = os.getcwd()
    os.chdir(root)                    # the configs' outputdir is relative
    for (cls, name), orig in patched.items():
        setattr(cls, name, (timed_step if name == "_train_step"
                            else measured_validate)(orig))
    try:
        for model, name, val_freq, extra in runs:
            cfg = cli_config(os.path.join(root, f"{name}.yaml"), name, train,
                             val_info, val_freq=val_freq, **extra)
            probe["steps"], probe["vals"], probe["groups"] = [], [], set()
            argv = ["--model", model, "--opt", cfg, "--use_valid"]
            if nccl:
                argv += ["--coordinator", free_address(), "--num_processes",
                         "1", "--process_id", "0"]
            reset(kernels)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = train_cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read(kernels)
            vals = probe["vals"]
            peak = max([torch.cuda.max_memory_allocated()]
                       + [v["run_peak"] for v in vals]) / 2 ** 30
            with open(trainer.metrics.path) as f:
                rows = [json.loads(line) for line in f]
            # steps 3..12: the wait before each (the loader) and the step
            # itself; the wait that holds the validation is left out
            spans = probe["steps"]
            waits = [b[0] - a[1] for a, b in zip(spans[1:], spans[2:])]
            busy = [b[1] - b[0] for b in spans[2:]]
            if vals:
                drop = int(np.argmax(waits))
                waits = waits[:drop] + waits[drop + 1:]
            want_group = {("nccl", 1)} if nccl else {None}
            if probe["groups"] != want_group or \
                    torch.distributed.is_initialized():
                raise AssertionError(f"cli {model} ({tag}): process groups "
                                     f"{probe['groups']}, want {want_group}"
                                     " during the steps and none after")
            out[model] = stats = dict(
                steps_per_s=step_rate(rows), peak_gib=peak, wall=wall,
                launches=launches, rows=rows, trainer=trainer,
                wait_ms=1e3 * float(np.mean(waits)),
                step_ms=1e3 * float(np.mean(busy)), vals=vals)
            batch = trainer.train_loader.batch_size
            stats["items_per_s"] = {} if nccl else {   # the loader alone
                w: loader_rate(trainer.train_set, batch, w,
                               LOADER_ITEMS if w else batch)
                for w in (trainer.train_loader.num_workers, 0)}
    finally:
        for (cls, name), orig in patched.items():
            setattr(cls, name, orig)
        os.chdir(cwd)

    for model, st in out.items():
        trainer, rows = st["trainer"], st["rows"]
        steps = [r for r in rows if "val/psnr" not in r]
        vals = [r for r in rows if "val/psnr" in r]
        terms = [k for k in steps[0] if k not in ("step", "time", "lr",
                                                  "it_per_s")]
        log(f"cli {model} ({tag}): {len(steps)} steps from disk, "
            f"{st['steps_per_s']:.4f} steps/s through the loader "
            f"(steps 3-12, the validation's interval left out; "
            f"batch {trainer.train_loader.batch_size}, "
            f"{trainer.train_loader.num_workers} workers); run wall "
            f"{st['wall']:.2f} s; loader alone "
            + (", ".join(f"{w} workers {r:.3f} items/s"
                         for w, r in st["items_per_s"].items())
               or "not timed")
            + f"; peak device memory {st['peak_gib']:.3f} GiB; launches "
            f"{st['launches']}; {smi}")
        share = st["wait_ms"] / (st["wait_ms"] + st["step_ms"])
        log(f"cli {model} ({tag}) steps 3-12: waiting on the loader "
            f"{st['wait_ms']:.2f} ms/step, in the step (synchronized) "
            f"{st['step_ms']:.2f} ms/step; host data share {share:.4f}")
        for v, probe_v in zip(vals, st["vals"]):
            log(f"cli {model} ({tag}) validation: " + json.dumps(
                {k: round(v[k], 6) for k in v if k.startswith("val/")})
                + f"; {probe_v['s']:.3f} s, peak device memory "
                f"{probe_v['peak'] / 2 ** 30:.3f} GiB (the run's peak "
                f"before it {probe_v['run_peak'] / 2 ** 30:.3f} GiB)")
        if [r["step"] for r in steps] != list(range(1, CLI_STEPS + 1)):
            raise AssertionError(f"cli {model}: steps {steps}")
        if not all(np.isfinite(r[k]) for r in steps for k in terms):
            raise AssertionError(f"cli {model}: a loss term is not finite")
        if len(vals) != 1 or not all(
                np.isfinite(vals[0][f"val/{k}"])
                for k in ("psnr", "ssim", "l1", "l2")):
            raise AssertionError(f"cli {model}: val/* missing or not finite")
        if trainer.train_loader._pool is not None:
            raise AssertionError(f"cli {model}: loader workers left running")
    for model in ("lafc_single", "lafc"):
        if any(out[model]["launches"].values()):
            raise AssertionError(f"cli {model}: stage 1 launched a kernel: "
                                 f"{out[model]['launches']}")
    fgt = out["model"]
    blocks = int(fgt["trainer"].opt["numBlocks"]) // 2
    k2_in_val = [sum(v["k2"] for v in fgt["vals"]), len(fgt["vals"])]
    want_val = k2_in_val[1] * 2 * blocks      # 2 videos, a forward each
    want = {"flash_mhsa": 4 * CLI_STEPS + want_val,
            "flash_attention_dq": 4 * CLI_STEPS,
            "flash_attention_dkv": 4 * CLI_STEPS,
            "lookup_corr_fused": 0, "lookup_corr_pyramid": 0}
    log(f"cli model: K2 in validate_fgt {k2_in_val[0]} launches over "
        f"{k2_in_val[1]} validation(s) (want {want_val}: 2 videos x "
        f"{blocks} temporal blocks); all launches {fgt['launches']}")
    if fgt["launches"] != want or k2_in_val[0] != want_val:
        raise AssertionError(f"cli model: launches {fgt['launches']}, want "
                             f"{want}")
    log(f"cli train phase ({tag}): {time.perf_counter() - t_phase:.2f} s")
    for st in out.values():
        del st["trainer"], st["rows"], st["vals"]
    torch.cuda.empty_cache()
    return out


# ---------------- data parallelism: two ranks on one card ----------------

DP_STEPS = 12           # steps of each two-rank run: 3 global batches x 4
DP_METRIC_RTOL = 1e-3   # each metric of steps 1-3, of its largest |value|
DP_METRIC_STEPS = 3
DP_OUT_RTOL = 2e-2      # |out(2 ranks) - out(1)| / |out(1) - out(init)|


def dp_batches(kind: str) -> list:
    """Three global batches (numpy) for two ranks: stage 1
    ``lafc_train_batch``'s recipe with 8 windows (4 a rank, the committed
    batch), FGT ``synthetic_train_batch``'s with 4 (2 a rank)."""
    out = []
    for s in range(3):
        if kind == "model":
            out.append(synthetic_train_batch(b=4, seed=30 + s))
        else:
            out.append({k: v.cpu().numpy() for k, v in
                        lafc_train_batch(b=8, seed=30 + s).items()})
    return out


def dp_probe(kind: str, models: dict, states: dict, batch: dict) -> dict:
    """Each model's output on ``batch`` (f32, no grad) with ``states``
    (model name -> state dict) loaded: the generator on the masked frames
    with the batch's flows, the discriminator on the frames, LAFC(-single)
    on the diffused flows (its pivot for the single model)."""
    import torch

    b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    out = {}
    with torch.no_grad():
        for name, mod in models.items():
            mod.load_state_dict(states[name])
            if name == "gen":
                out[name] = mod(b["frames"] * (1 - b["masks"]),
                                b["forward_flo"], b["masks"])
            elif name == "disc":
                out[name] = mod(b["frames"])
            elif kind == "lafc_single":
                out[name] = mod(b["diffused_flows"][:, 1],
                                b["masks"][:, 1])[0]
            else:
                out[name] = mod(b["diffused_flows"], b["masks"])[0]
    return out


def dp_ranks(runs: dict, root: str):
    """Two gloo ranks on cuda:0 (``tests/torch_port_dp_worker.py``, one
    process a rank for every run): each run ``kind -> (opt, batches)``
    on each rank's half of every global batch. Returns ({kind: (rank 0's
    metric rows, the ranks' saved models and launch counts)}, wall
    seconds of the two processes)."""
    import torch

    specs = []
    for kind, (opt, batches) in runs.items():
        npz = os.path.join(root, f"{kind}_batches.npz")
        np.savez(npz, **{f"{s}/{k}": v for s, b in enumerate(batches)
                         for k, v in b.items()})
        specs.append(os.path.join(root, f"{kind}_spec.json"))
        with open(specs[-1], "w") as f:
            json.dump({"kind": kind, "world": 2, "address": free_address(),
                       "device": "cuda:0", "opt": opt, "batches": npz,
                       "out": root}, f)
    torch.cuda.empty_cache()
    worker = os.path.join(REPO, "tests", "torch_port_dp_worker.py")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, worker, str(r), *specs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(text[-6000:])
            raise AssertionError(f"dp gloo: rank {r} exited {p.returncode}")
    out = {}
    for kind, (opt, _) in runs.items():
        with open(os.path.join(root, opt["name"], "tb",
                               "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        out[kind] = (rows, [torch.load(os.path.join(
            root, f"{kind}_rank{r}.pt")) for r in range(2)])
    return out, wall


def dp_single(kind: str, opt: dict, batches: list, kernels):
    """One process on the global batches. Returns (metric rows, the
    initial and the trained state dicts, the models, launches, wall)."""
    import torch
    from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer

    reset(kernels)
    t0 = time.perf_counter()
    trainer = (FGTTrainer if kind == "model" else LAFCTrainer)(opt)
    models = ({"gen": trainer.gen, "disc": trainer.disc} if kind == "model"
              else {"model": trainer.model})

    def snapshot():
        return {m: {k: t.detach().clone() for k, t in
                    mod.state_dict().items()} for m, mod in models.items()}

    init = snapshot()
    trainer.train([{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                   for b in batches])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(kernels)
    return read_metrics(trainer, 0), init, snapshot(), models, launches, wall


def dp_distance(kind, rows, one_rows, states, init, trained, models,
                batch) -> tuple:
    """(max over the first ``DP_METRIC_STEPS`` steps and the metrics of
    |a - b| / the metric's largest |value| in ``one_rows``, the same over
    all steps, and per model |out(states) - out(trained)| /
    |out(trained) - out(init)| on ``batch``)."""
    names = [k for k in one_rows[0] if k not in ("step", "time", "lr",
                                                 "it_per_s")]
    errs = [max(abs(a[k] - b[k]) / max(max(abs(r[k]) for r in one_rows),
                                        1e-6) for k in names)
            for a, b in zip(rows, one_rows)]
    o0, o1, o2 = (dp_probe(kind, models, sd, batch)
                  for sd in (init, trained, states))
    return max(errs[:DP_METRIC_STEPS]), max(errs), {
        m: float((o2[m] - o1[m]).norm() / (o1[m] - o0[m]).norm())
        for m in models}


def phase_dp_gloo(kernels, root: str, smi: str) -> dict:
    """Data parallelism with two ranks on one card: for each committed
    config (full width, f32, TF32 off) two processes
    (``tests/torch_port_dp_worker.py``) join a gloo group on cuda:0 (NCCL
    refuses two ranks on one device; gloo reduces the CUDA tensors through
    the host) and train through the trainers, which find the group
    initialised, each on its half of 3 global batches for 12 steps; then
    one process trains on the whole batches, and once more on the same
    batches with their halves swapped (the same update in exact
    arithmetic, summed in another order: the reference spread, how far
    this training carries a reassociation by 12 steps).

    Two ranks must match one process: every logged metric (the ranks'
    mean) of the first ``DP_METRIC_STEPS`` steps within
    ``DP_METRIC_RTOL`` of its largest magnitude over the run (the GAN's
    terms cross zero; later steps are printed beside the spread, which
    reaches 1e-3 by step 12 for the GAN); each trained model's output on
    the first global batch, its distance from the one process's over the
    distance that process's training moved it from the init's, within
    ``max(DP_OUT_RTOL, 2 x spread)``. Outputs, not weights: Adam moves a
    weight whose gradient is zero in exact arithmetic, as attention's key
    bias, by about lr a step in the direction of its rounding noise,
    which changes no output. The two replicas must be
    equal bit for bit; K2, K4, K5 4 times a FGT step on each rank and on
    the single process, none in stage 1. Steps/s over steps 3-12 of the
    two ranks and of one process. ``kernels``: the K1-K5 counters."""
    import torch
    from fgt_tpu_torch.models import lafc_single
    from fgt_tpu_torch.utils import checkpoint

    oracle = os.path.join(root, "oracle.pth")
    checkpoint.save(lafc_single.init_lafc_single(
        lafc_single.Model(committed_config("fgt_train")["flow_config"]),
        torch.Generator().manual_seed(0)).state_dict(), oracle)
    runs = {}
    for kind in ("lafc_single", "lafc", "model"):
        opt = (train_opt(root, flow_checkPoint=oracle) if kind == "model"
               else lafc_opt(root, kind == "lafc_single"))
        opt.update(mixed_precision=0, name=f"{kind}_dp2")
        opt["train"].update(MAX_ITERS=DP_STEPS)
        runs[kind] = (opt, dp_batches(kind))
    ranked, wall = dp_ranks(runs, root)
    log(f"dp gloo: two rank processes trained all three configs in "
        f"{wall:.2f} s (start-up included)")
    out = {}
    for kind, (opt, batches) in runs.items():
        lr = float(opt["train"]["lr"])
        rows, ranks = ranked[kind]
        one_rows, init, trained, models, launches, one_wall = dp_single(
            kind, dict(opt, name=f"{kind}_dp1"), batches, kernels)
        half = len(next(iter(batches[0].values()))) // 2
        swapped = [{k: np.concatenate([v[half:], v[:half]])
                    for k, v in b.items()} for b in batches]
        sw_rows, _, sw_trained, _, _, _ = dp_single(
            kind, dict(opt, name=f"{kind}_dp1s"), swapped, kernels)
        dp = dp_distance(kind, rows, one_rows, ranks[0]["models"], init,
                         trained, models, batches[0])
        spread = dp_distance(kind, sw_rows, one_rows, sw_trained, init,
                             trained, models, batches[0])
        o_tol = {m: max(DP_OUT_RTOL, 2 * v) for m, v in spread[2].items()}
        p_lr = max(float((ranks[0]["models"][m][k].cuda() - t).abs().max())
                   for m in models for k, t in trained[m].items()
                   if t.is_floating_point()) / lr
        equal = all(torch.equal(ranks[0]["models"][m][k],
                                ranks[1]["models"][m][k])
                    for m in models for k in ranks[0]["models"][m])
        rates = [step_rate(rows), step_rate(one_rows)]
        per_step = 4 * DP_STEPS if kind == "model" else 0
        want = {"flash_mhsa": per_step, "flash_attention_dq": per_step,
                "flash_attention_dkv": per_step}
        log(f"dp gloo {kind}: 2 ranks on cuda:0 (gloo, f32) {rates[0]:.4f} "
            f"steps/s vs one process on the global batch {rates[1]:.4f} "
            f"(ratio {rates[0] / rates[1]:.4f}; steps 3-12, global batch "
            f"{2 * half}); one process's wall {one_wall:.2f} s; {smi}")
        log(f"dp gloo {kind}: metrics max err of their largest value, "
            f"steps 1-{DP_METRIC_STEPS} {dp[0]:.3g} (swapped-halves spread "
            f"{spread[0]:.3g}, tol {DP_METRIC_RTOL}), steps 1-{DP_STEPS} "
            f"{dp[1]:.3g} (spread {spread[1]:.3g}); outputs |2 ranks - 1| / "
            f"|1 - init| "
            + ", ".join(f"{m} {v:.3g} (spread {spread[2][m]:.3g}, tol "
                        f"{o_tol[m]:.3g})" for m, v in dp[2].items())
            + f"; largest weight difference {p_lr:.3g} x lr; replicas "
            f"bit-equal {equal}; launches rank 0 {ranks[0]['launches']}, "
            f"rank 1 {ranks[1]['launches']}, one process {launches}")
        if len(rows) != DP_STEPS or len(one_rows) != DP_STEPS:
            raise AssertionError(f"dp gloo {kind}: {len(rows)} / "
                                 f"{len(one_rows)} steps logged")
        if not (dp[0] <= DP_METRIC_RTOL and equal
                and all(v <= o_tol[m] for m, v in dp[2].items())):
            raise AssertionError(f"dp gloo {kind}: two ranks and one "
                                 "process disagree")
        for got in (ranks[0]["launches"], ranks[1]["launches"]):
            if any(got[k] != n for k, n in want.items()):
                raise AssertionError(f"dp gloo {kind}: launches {got}, want "
                                     f"{want} a rank")
        expect_launches(f"dp gloo {kind} (one process)", launches,
                        dict(want, lookup_corr_fused=0,
                             lookup_corr_pyramid=0))
        out[kind] = dict(rates=rates, err=dp, spread=spread)
        del models
        torch.cuda.empty_cache()
    return out


def phase_dp_train(kernels, root: str, smi: str, plain: dict) -> dict:
    """Data-parallel training: the three committed configs from disk
    through the training CLI in a one-rank NCCL group, their steps/s
    beside ``plain`` (the same phase without a group); then two gloo
    ranks on one card against one process (:func:`phase_dp_gloo`)."""
    cli_root, gloo_root = (os.path.join(root, d) for d in ("cli", "gloo"))
    os.makedirs(cli_root)
    os.makedirs(gloo_root)
    nccl = phase_cli_train(kernels, cli_root, smi, nccl=True)
    log("training from disk, one NCCL rank (--coordinator) vs no group: "
        + "; ".join(f"{m} {nccl[m]['steps_per_s']:.4f} vs "
                    f"{plain[m]['steps_per_s']:.4f} steps/s" for m in plain)
        + f"; {smi}")
    return {"nccl": nccl, "gloo": phase_dp_gloo(kernels, gloo_root, smi)}


# ---------------- tensor and sequence parallelism: two ranks, one card ----

PAR_STEPS = 6           # steps of each tp / sp training run: 3 batches x 2
PAR_MESHES = {"--tp 2": ["--tp", "2"], "--sp 2": ["--sp", "2"],
              "--dp": ["--dp", "--window_batch", "4"]}


def par_ranks(specs: list, root: str) -> float:
    """Two gloo ranks on cuda:0 (``tests/torch_port_parallel_worker.py``,
    one process a rank running every SPEC in turn). Returns their wall
    seconds."""
    import torch

    torch.cuda.empty_cache()
    worker = os.path.join(REPO, "tests", "torch_port_parallel_worker.py")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, worker, str(r), *specs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(text[-6000:])
            raise AssertionError(f"parallel: rank {r} exited {p.returncode}")
    return time.perf_counter() - t0


def par_spec(root: str, name: str, **kw) -> str:
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(dict(kw, name=name, world=2, tp=kw.get("tp", 1),
                       sp=kw.get("sp", 1), address=free_address(),
                       device="cuda:0", out=root), f)
    return path


def par_load(root: str, name: str) -> list:
    import torch

    return [torch.load(os.path.join(root, f"{name}_rank{r}.pt"),
                       weights_only=False) for r in range(2)]


def par_one_process(argv: list, passes: int) -> dict:
    """The CLI's models and load-and-inpaint step in this process (no
    group), ``passes`` times (cold, then warm): the last pass's output,
    stage seconds, K1 and K2 launches, peak memory, and the FGT parameter
    bytes."""
    import torch
    from fgt_tpu_torch.ops import corr_fused, flash_attention as fa
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    args = vi.build_parser().parse_args(argv)
    models = vi.build_models(args)
    counters = (corr_fused.lookup_corr_fused, fa.flash_mhsa)
    for _ in range(passes):
        reset(counters)
        torch.cuda.reset_peak_memory_stats()
        timer = vi.StageTimer("cuda")
        out = vi.inpaint_from_args(args, models, timer)
    res = dict(out=out, stages=dict(timer.times), launches=read(counters),
               peak=torch.cuda.max_memory_allocated(),
               fgt_bytes=sum(p.numel() * p.element_size()
                             for p in models.fgt.parameters()))
    del models
    torch.cuda.empty_cache()
    return res


def phase_parallel(kernels, root: str, smi: str) -> dict:
    """Tensor parallelism (``--tp 2``), sequence parallelism (``--sp 2``)
    and the inference CLI's ``--dp`` with two gloo ranks sharing cuda:0
    (``tests/torch_port_parallel_worker.py``; NCCL refuses two ranks on
    one card), cuDNN's deterministic algorithms on, TF32 off.

    Inference: object removal, 24 synthetic frames at 432x240 (flows at
    864x480), full width (FGT 512 hidden, 4 heads, 8 blocks), random
    weights from seed 0, through the CLI's ``build_models`` and
    load-and-inpaint step, in f32 (one pass) and in bf16 (cold, then
    warm), under each of ``--tp 2``, ``--sp 2`` and ``--dp --window_batch
    4`` (s6 in chunks of 4 windows and 1, so the 4 are shared); each
    against one process with the same flags but the mesh's (and
    ``--host_diffusion``, the solve a mesh takes). In f32 the output equals the input outside the
    hole and one process's inside it within 1 u8 level; in bf16 the mean
    |2 ranks - 1| in the hole is within twice one process's own mean
    |bf16 - f32| there; the two ranks' outputs are equal; K1 launches 20
    a pass on each rank (46 pairs, 23 a rank under --dp) and K2 4 a
    pass at N = windows x 4 cells x heads / (tp x sp) (8 under --dp:
    N 32 for the 2 windows a rank, 16 for the replicated last one).

    Training: ``configs/fgt_train.yaml`` (f32, TF32 off) through
    ``FGTTrainer`` under ``tp 2`` and under ``sp 2`` on 3 global batches
    of 2 made on the card, 6 steps, against one process on the same
    batches and once more with each batch's two items swapped (the
    reference spread): the data-parallel phase's rule (metrics of the first
    ``DP_METRIC_STEPS`` steps within ``DP_METRIC_RTOL`` of their largest
    value; trained outputs within ``max(DP_OUT_RTOL, 2 x spread)``), the
    discriminator and the generator's replicated leaves bit-equal on the
    two ranks, K2, K4, K5 4 a step on each rank at N 16 (batch 2 x 4
    cells x 4 heads / 2), L 900.

    Prints each rank's FGT parameter bytes, ``tp_param_fraction`` of the
    full generator, peak memory, and the two ranks' frames/s and steps/s
    beside one process's: the ranks time-slice one card, so these are
    not a scaling measurement. ``kernels``: the K1-K5 counters."""
    import torch
    from fgt_tpu_torch.models import fgt as fgt_mod
    from fgt_tpu_torch.models import lafc_single
    from fgt_tpu_torch.parallel import partition
    from fgt_tpu_torch.pipeline import video_inpainting as vi
    from fgt_tpu_torch.utils import checkpoint

    frames, masks = synthetic_video()
    base = CLI_RANDOM + ["--path", write_pngs(f"{root}/frames", frames),
                         "--path_mask", write_pngs(f"{root}/masks",
                                                   masks * 255),
                         "--outroot", f"{root}/out"]
    dtypes = {"f32": ["--f32"], "bf16": []}
    passes = {"f32": 1, "bf16": 2}
    specs = [par_spec(root, f"inf_{m[2:4]}_{d}", job="inference",
                      passes=passes[d], argv=base + flags + dflags)
             for m, flags in PAR_MESHES.items()
             for d, dflags in dtypes.items()]
    oracle = os.path.join(root, "oracle.pth")
    checkpoint.save(lafc_single.init_lafc_single(
        lafc_single.Model(committed_config("fgt_train")["flow_config"]),
        torch.Generator().manual_seed(0)).state_dict(), oracle)
    batches = [synthetic_train_batch(b=2, seed=40 + s) for s in range(3)]
    npz = os.path.join(root, "batches.npz")
    np.savez(npz, **{f"{s}/{k}": v for s, b in enumerate(batches)
                     for k, v in b.items()})

    def opt(name):
        o = train_opt(root, flow_checkPoint=oracle, mixed_precision=0,
                      name=name)
        o["train"].update(MAX_ITERS=PAR_STEPS)
        return o

    axes = {"tp": (2, 1), "sp": (1, 2)}
    specs += [par_spec(root, f"train_{a}", job="train", tp=tp, sp=sp,
                      opt=opt(f"par_{a}"), batches=npz)
              for a, (tp, sp) in axes.items()]
    wall = par_ranks(specs, root)
    log(f"parallel: two rank processes ran 6 inference and 2 training "
        f"configurations in {wall:.2f} s (start-up included)")

    full = fgt_mod.Model(vi.DEFAULT_FGT_CONFIG).state_dict()
    frac = partition.tp_param_fraction(full, 2)
    full_bytes = sum(t.numel() * 4 for t in full.values())
    log(f"parallel: tp_param_fraction of the full generator at tp 2 "
        f"{frac:.4f} (the JAX audit asks > 0.6); its f32 parameters "
        f"{full_bytes / 2 ** 20:.2f} MiB in one process")
    if frac <= 0.6:
        raise AssertionError(f"tp_param_fraction {frac}")

    hole = masks > 0
    out, refs = {}, {}
    for m, flags in PAR_MESHES.items():
        ref = {}
        for d, dflags in dtypes.items():
            argv = (base + flags[1:] * (m == "--dp") + dflags
                    + ["--host_diffusion"])
            if tuple(argv) not in refs:     # --tp 2 and --sp 2 share one
                refs[tuple(argv)] = par_one_process(argv, passes[d])
            ref[d] = refs[tuple(argv)]
        for d in dtypes:
            name = f"inf_{m[2:4]}_{d}"
            ranks = par_load(root, name)
            warm = [r["passes"][-1] for r in ranks]
            got = ranks[0]["out"]
            diff = np.abs(got.astype(np.int16) - ref[d]["out"])
            equal = np.array_equal(got, ranks[1]["out"])
            fps = [24 / sum(p["stages"].values()) for p in warm]
            one_fps = 24 / sum(ref[d]["stages"].values())
            pass_label = "warm" if passes[d] > 1 else "cold"
            shapes = sorted(set(warm[0]["k2_shapes"]))
            log(f"parallel {m} {d}: 2 ranks on cuda:0 (gloo, time-sliced, "
                f"not scaling) {fps[0]:.3f} / {fps[1]:.3f} frames/s "
                f"{pass_label} vs one process {one_fps:.3f}; FGT parameters "
                f"a rank "
                f"{ranks[0]['fgt_bytes'] / 2 ** 20:.2f} / "
                f"{ranks[1]['fgt_bytes'] / 2 ** 20:.2f} MiB vs "
                f"{ref[d]['fgt_bytes'] / 2 ** 20:.2f}; peak "
                f"{warm[0]['peak'] / 2 ** 30:.2f} / "
                f"{warm[1]['peak'] / 2 ** 30:.2f} GiB vs "
                f"{ref[d]['peak'] / 2 ** 30:.2f}; launches a rank "
                f"{warm[0]['launches']} / {warm[1]['launches']} vs "
                f"{ref[d]['launches']}; K2 (N, L) {shapes}; |2 ranks - 1| "
                f"max {int(diff.max())}, {int((diff > 0).sum())} values "
                f"differ; ranks equal {equal}; {smi}")
            if got.shape != (24, 240, 432, 3) or got.dtype != np.uint8 \
                    or not equal:
                raise AssertionError(f"parallel {m} {d}: output {got.shape}"
                                     f" {got.dtype}, ranks equal {equal}")
            if d == "f32" and (diff.max() > 1 or not np.array_equal(
                    got[~hole], frames[~hole])):
                raise AssertionError(f"parallel {m} f32: max |2 ranks - 1| "
                                     f"{diff.max()} or the input changed "
                                     "outside the hole")
            heads = 4 // (2 if m != "--dp" else 1)
            want_n = ([5 * 4 * heads] * 4 if m != "--dp"
                      else [2 * 4 * 4] * 4 + [4 * 4] * 4)
            for p in warm:
                n_seen = sorted(n for n, _ in p["k2_shapes"])
                if p["launches"] != {"lookup_corr_fused": 20,
                                     "flash_mhsa": len(want_n)} \
                        or n_seen != sorted(want_n):
                    raise AssertionError(f"parallel {m} {d}: launches "
                                         f"{p['launches']}, K2 N {n_seen}; "
                                         f"want 20 K1, K2 N {want_n}")
        spread = np.abs(ref["bf16"]["out"].astype(np.float64)
                        - ref["f32"]["out"])[hole].mean()
        dev = np.abs(par_load(root, f"inf_{m[2:4]}_bf16")[0]["out"]
                     .astype(np.float64) - ref["bf16"]["out"])[hole].mean()
        log(f"parallel {m} bf16: mean |2 ranks - 1| in the hole {dev:.4f} "
            f"u8 levels, one process's own mean |bf16 - f32| {spread:.4f}")
        if dev > 2 * spread:
            raise AssertionError(f"parallel {m} bf16: {dev} > 2 x {spread}")
        out[m] = dict(spread=spread, dev=dev)

    # one process on the batches, and on them with their items swapped
    one_rows, init, trained, models, launches, _ = dp_single(
        "model", opt("par_1"), batches, kernels)
    swapped = [{k: v[::-1].copy() for k, v in b.items()} for b in batches]
    sw_rows, _, sw_trained, _, _, _ = dp_single(
        "model", opt("par_1s"), swapped, kernels)
    for a, (tp, sp) in axes.items():
        ranks = par_load(root, f"train_{a}")
        with open(os.path.join(ranks[0]["run_dir"], "tb",
                               "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        states = {"gen": ranks[0]["gen"], "disc": ranks[0]["own"]["disc"]}
        err = dp_distance("model", rows, one_rows, states, init, trained,
                          models, batches[0])
        spread = dp_distance("model", sw_rows, one_rows, sw_trained, init,
                             trained, models, batches[0])
        o_tol = {m: max(DP_OUT_RTOL, 2 * v) for m, v in spread[2].items()}
        specs_full = partition.partition_specs(init["gen"], tp)
        replicated_equal = all(
            torch.equal(ranks[0]["own"]["gen"][k], ranks[1]["own"]["gen"][k])
            for k in ranks[0]["own"]["gen"] if specs_full[k] is None)
        disc_equal = all(torch.equal(ranks[0]["own"]["disc"][k],
                                     ranks[1]["own"]["disc"][k])
                         for k in ranks[0]["own"]["disc"])
        rates = [step_rate(rows), step_rate(one_rows)]
        log(f"parallel training {a} 2: 2 ranks on cuda:0 (gloo, f32, "
            f"time-sliced, not scaling) {rates[0]:.4f} steps/s vs one "
            f"process {rates[1]:.4f}; generator parameters a rank "
            f"{ranks[0]['param_bytes']['gen'] / 2 ** 20:.2f} / "
            f"{ranks[1]['param_bytes']['gen'] / 2 ** 20:.2f} MiB vs "
            f"{full_bytes / 2 ** 20:.2f}; peak {ranks[0]['peak'] / 2 ** 30:.2f}"
            f" / {ranks[1]['peak'] / 2 ** 30:.2f} GiB; {smi}")
        log(f"parallel training {a} 2: metrics max err of their largest "
            f"value, steps 1-{DP_METRIC_STEPS} {err[0]:.3g} (swapped spread "
            f"{spread[0]:.3g}, tol {DP_METRIC_RTOL}), steps 1-{PAR_STEPS} "
            f"{err[1]:.3g} (spread {spread[1]:.3g}); outputs |2 ranks - 1| "
            f"/ |1 - init| " + ", ".join(
                f"{m} {v:.3g} (spread {spread[2][m]:.3g}, tol "
                f"{o_tol[m]:.3g})" for m, v in err[2].items())
            + f"; replicated generator leaves equal {replicated_equal}, "
            f"discriminator equal {disc_equal}; launches rank 0 "
            f"{ranks[0]['launches']}, rank 1 {ranks[1]['launches']}, one "
            f"process {launches}")
        if len(rows) != PAR_STEPS or len(one_rows) != PAR_STEPS:
            raise AssertionError(f"parallel training {a}: {len(rows)} / "
                                 f"{len(one_rows)} steps logged")
        if not (err[0] <= DP_METRIC_RTOL and replicated_equal and disc_equal
                and all(v <= o_tol[m] for m, v in err[2].items())):
            raise AssertionError(f"parallel training {a}: two ranks and "
                                 "one process disagree")
        want = {n: 4 * PAR_STEPS for n in ("flash_mhsa", "flash_attention_dq",
                                           "flash_attention_dkv")}
        # batch 2 x 4 cells x 4 heads / 2 ranks; 5 frames x 180 tokens
        want_shapes = [(e, 16, 900) for e in (
            "flash_attention_dkv", "flash_attention_dq",
            "flash_attention_forward")]
        log(f"parallel training {a} 2: flash (entry, N, L) a rank "
            f"{ranks[0]['flash_shapes']} / {ranks[1]['flash_shapes']}")
        for r in ranks:
            if any(r["launches"][k] != n for k, n in want.items()) \
                    or [tuple(x) for x in r["flash_shapes"]] != want_shapes:
                raise AssertionError(f"parallel training {a}: launches "
                                     f"{r['launches']}, shapes "
                                     f"{r['flash_shapes']}; want {want} "
                                     f"at {want_shapes} a rank")
        out[a] = dict(rates=rates, err=err, spread=spread)
    del models
    torch.cuda.empty_cache()
    return out


# ---------------- the overfit quality gate ----------------

def phase_overfit_gate(kernels, root: str, smi: str) -> dict:
    """``python -m fgt_tpu_torch.tools.overfit_gate``'s ``main``, both
    protocols at full size on the card (24 frames at 432x240, LAFC 150
    and FGT 100 f32 steps; ``--fgt_only``: FGT 100 steps on the static
    clip), each with the counts set to 0 before it and read after it:
    K1 20 and K2 4 in each of its 2 inference runs, K2, K4, K5 4 a FGT
    step, no K3. Each protocol must improve its PSNR (exit status 0).
    Runs under PyTorch's default TF32 settings (convolutions on TF32,
    matmuls in f32), as the tool runs on its own."""
    import torch
    from fgt_tpu_torch.tools import overfit_gate as gate

    out = os.path.join(root, "overfit_gate_torch.json")
    res = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for fgt_only in (False, True):
            res["fgt_only" if fgt_only else "full"] = overfit_protocol(
                gate, kernels, out, fgt_only, smi)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return res


def overfit_protocol(gate, kernels, out: str, fgt_only: bool,
                     smi: str) -> dict:
    """One protocol of :func:`phase_overfit_gate`: the tool's ``main``
    with the counts reset before it and read after it."""
    label = "fgt_only" if fgt_only else "full"
    fgt_steps = 100
    argv = ["--out", out, "--device", "cuda", "--lafc_steps", "150",
            "--fgt_steps", str(fgt_steps), "--frames", "24"]
    reset(kernels)
    t0 = time.perf_counter()
    rc = gate.main(argv + (["--fgt_only"] if fgt_only else []))
    wall = time.perf_counter() - t0
    launches = read(kernels)
    with open(out) as f:
        rec = json.load(f)
    rec = rec["fgt_only"] if fgt_only else rec
    log(f"overfit gate ({label}): exit status {rc}, {wall:.2f} s; "
        + json.dumps({k: v for k, v in rec.items() if k != "protocol"})
        + f"; launches {launches}; {smi}")
    expect_launches(f"overfit gate ({label})", launches, {
        "lookup_corr_fused": 2 * 20, "lookup_corr_pyramid": 0,
        "flash_mhsa": 2 * 4 + 4 * fgt_steps,
        "flash_attention_dq": 4 * fgt_steps,
        "flash_attention_dkv": 4 * fgt_steps})
    if rc != 0 or not rec["improved"]:
        raise AssertionError(f"overfit gate ({label}): the PSNR did not "
                             "improve")
    return dict(rec, wall=wall, launches=launches)


def profile_steps(trainer, batch):
    """Device time of two training steps (torch.profiler): busy and idle
    share, the flash kernels' share, time by operator and by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.total_iterations = trainer.current_step + 1
    trainer.train([batch])                    # warm, outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.current_step += 1
            trainer._train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(kernel_events(prof),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 2e3
    flash = sum(e.self_device_time_total for e in kernels
                if "flash_" in e.key) / 2e3
    log(f"profile: {wall / 2 * 1e3:.3f} ms/step wall under the profiler; "
        f"kernels {busy:.3f} ms/step (idle share "
        f"{max(0.0, 1 - busy / (wall / 2 * 1e3)):.3f}); K2+K4+K5 "
        f"{flash:.3f} ms/step ({flash / busy:.3f} of kernel time)")
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.device_time_total)
    for e in ops[:12]:
        log(f"profile op: {e.device_time_total / 2e3:9.3f} ms/step "
            f"x{e.count // 2:5d}  {e.key}")
    for e in kernels[:16]:
        log(f"profile kernel: {e.self_device_time_total / 2e3:9.3f} ms/step "
            f"x{e.count // 2:5d}  {e.key[:110]}")


def conv_types_removal(counters, root: str, smi: str, vanilla_s: dict):
    """Object removal with gated LAFC (cnum 48) and gated BN FGT (512
    hidden, 8 blocks, 4 heads), bf16, on the K1 path, from JAX-layout
    ``.msgpack`` directories the port writes (seeded weights, BN's running
    statistics perturbed) and its CLI reads back strictly; cold, then
    warm. Returns the warm stage seconds."""
    import torch
    from fgt_tpu_torch.convert import weights
    from fgt_tpu_torch.pipeline import video_inpainting as vi
    from fgt_tpu_torch.utils import checkpoint

    lafc_cfg = dict(vi.DEFAULT_LAFC_CONFIG, conv_type="gated",
                    input_resolution=[240, 432])
    fgt_cfg = dict(vi.DEFAULT_FGT_CONFIG, conv_type="gated", norm="BN",
                   input_resolution=[240, 432], kernel_size=[7, 7])
    models = vi.Models("cpu", bf16=False, seed=0, lafc_config=lafc_cfg,
                       fgt_config=fgt_cfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in models.fgt.named_parameters():
            if name.endswith("running_mean"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith("running_var"):
                p.copy_(0.8 + 0.4 * torch.rand(p.shape, generator=gen))
    ck = f"{root}/gated"
    for kind, module, cfg in (("lafc", models.lafc, lafc_cfg),
                              ("fgt", models.fgt, fgt_cfg)):
        os.makedirs(f"{ck}/{kind}")
        with open(f"{ck}/{kind}/config.yaml", "w") as f:
            f.write(block_yaml(cfg))
        write_jax_layout(module.state_dict(), weights.mapping_for(kind, cfg),
                         f"{ck}/{kind}/{kind}.msgpack")
        back = vi._load_ckpt_dir(f"{ck}/{kind}", vi.DEFAULT_FGT_CONFIG
                                 if kind == "fgt" else
                                 vi.DEFAULT_LAFC_CONFIG)[1]
        own = module.state_dict()
        if set(back) != set(own) or not all(
                torch.equal(back[k], own[k]) for k in own):
            raise AssertionError(f"gated {kind}: the msgpack read back "
                                 "differs from the weights written")
    write_jax_layout(models.raft.state_dict(), weights.raft_mapping(),
                     f"{ck}/raft.msgpack")
    n_gate = sum(p.numel() for n, p in models.fgt.named_parameters()
                 if "gatingConv" in n)
    del models
    frames, masks = synthetic_video()
    np.save(f"{ck}/frames.npy", frames)
    np.save(f"{ck}/masks.npy", masks)
    for label in ("cold", "warm"):
        out, _, _ = run_cli(f"gated BN object removal {label}", counters, [
            "--path", f"{ck}/frames.npy", "--path_mask", f"{ck}/masks.npy",
            "--outroot", f"{ck}/out_{label}", "--lafc_ckpts", f"{ck}/lafc",
            "--fgt_ckpts", f"{ck}/fgt", "--raft_model", f"{ck}/raft.msgpack"],
            {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0,
             "flash_mhsa": 4})
        if out.shape != (24, 240, 432, 3) or out.dtype != np.uint8:
            raise AssertionError(f"gated run: output {out.shape} {out.dtype}")
        keep = masks == 0
        if not np.array_equal(out[keep], frames[keep]):
            raise AssertionError("gated run: output differs from the input "
                                 "outside the hole")
    with open(f"{ck}/out_warm/timings.json") as f:
        stages = json.load(f)["stages"]
    work = {k: v for k, v in stages.items() if k[:2] in ("s1", "s2", "s3",
                                                          "s4", "s5", "s6")}
    log(f"gated BN vs vanilla, warm, same run: s2_lafc "
        f"{work['s2_lafc']:.4f} vs {vanilla_s['s2_lafc']:.4f} s, s6_fgt "
        f"{work['s6_fgt']:.4f} vs {vanilla_s['s6_fgt']:.4f} s, s1-s6 "
        f"{24 / sum(work.values()):.3f} vs "
        f"{24 / sum(vanilla_s.values()):.3f} frames/s (the vanilla pass "
        f"resident, the gated one through the CLI's loader); FGT gate "
        f"convs {n_gate / 1e6:.3f} M parameters; {smi}")
    return work


def conv_types_train(counters, root: str, smi: str, vanilla: dict) -> dict:
    """bf16 training with gated blocks: 6 stage-1 steps of
    configs/lafc_single_train.yaml and lafc_train.yaml with ``conv_type:
    gated``; then 6 GAN steps of configs/fgt_train.yaml with ``conv_type:
    gated`` under ``norm: SN`` and again under ``norm: BN``, the gated
    LAFC-single's checkpoint as the flow oracle (2 cold + 4 timed steps
    each): losses finite, K2, K4 and K5 4 a GAN step, BN's running
    statistics moved (Adam moves them, as the JAX step), SN's u and v
    unchanged; the flow encoder's statistics take gradients at the
    rounding level, so only the decoder's must move. steps/s beside
    ``vanilla``'s (this run's on-card rates)."""
    import torch
    from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer

    rates, oracle = {}, None
    for single in (True, False):
        label = "lafc_single" if single else "lafc"
        batch = lafc_train_batch()
        if single:
            for k in ("flows", "diffused_flows", "masks"):
                batch[k] = batch[k][:, 1]
        trainer = LAFCTrainer(lafc_opt(f"{root}/{label}", single,
                                       conv_type="gated"))
        if not any("gatingConv" in n for n, _ in
                   trainer.model.named_parameters()):
            raise AssertionError(f"gated {label}: no gate")
        trainer.total_iterations = 2
        trainer.train([batch])
        trainer.total_iterations = 6
        trainer.train([batch])
        rows = read_metrics(trainer, 2)
        if not all(np.isfinite(r[k]) for r in rows for k in LAFC_METRICS):
            raise AssertionError(f"gated {label}: a loss is not finite")
        rates[label] = (len(rows) - 1) / (rows[-1]["time"] - rows[0]["time"])
        if single:
            oracle = trainer.save_checkpoint(0)["gen_state"]
        del trainer
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synthetic_train_batch().items()}
    for norm in ("SN", "BN"):
        opt = train_opt(f"{root}/fgt_{norm}", flow_checkPoint=oracle,
                        conv_type="gated", norm=norm)
        opt["flow_config"] = dict(opt["flow_config"], conv_type="gated")
        trainer = FGTTrainer(opt)
        state0 = {k: v.detach().clone() for k, v in
                  trainer.gen.state_dict().items()
                  if k.endswith(("running_mean", "running_var", "weight_u",
                                 "weight_v"))}
        if len(state0) != (16 if norm == "BN" else 32):
            raise AssertionError(f"gated {norm}: {len(state0)} norm leaves")
        trainer.total_iterations = 2
        trainer.train([batch])
        reset(counters)
        trainer.total_iterations = 6
        trainer.train([batch])
        per_step = {k: v / 4 for k, v in read(counters).items()}
        rows = read_metrics(trainer, 2)
        keys = ("gen_loss", "dis_loss", "adv", "l1_valid", "l1_masked")
        if not all(np.isfinite(r[k]) for r in rows for k in keys):
            raise AssertionError(f"gated {norm}: a loss is not finite")
        if any(v != 4 for v in per_step.values()):
            raise AssertionError(f"gated {norm}: launches per step "
                                 f"{per_step}")
        now = trainer.gen.state_dict()
        moved = [k for k, v in state0.items() if not torch.equal(now[k], v)]
        decoder = sum("decoder" in k for k in moved)
        if (decoder != 8) if norm == "BN" else moved:
            raise AssertionError(f"gated {norm}: moved {moved}")
        label = f"model_{norm}"
        rates[label] = (len(rows) - 1) / (rows[-1]["time"] - rows[0]["time"])
        log(f"gated {norm} GAN: {len(rows)} logged steps, launches per step "
            f"{per_step}, {len(moved)} of {len(state0)} "
            f"{'BN statistics' if norm == 'BN' else 'SN u/v'} moved "
            f"({decoder} of the decoder's); "
            f"gen_loss {rows[0]['gen_loss']:.4f} -> "
            f"{rows[-1]['gen_loss']:.4f}")
        del trainer
        torch.cuda.empty_cache()
    log("gated training, steps/s vs vanilla (same run): " + "; ".join(
        f"{k} {v:.4f} vs {vanilla[k.split('_')[0] if k.startswith('model') else k]:.4f}"
        for k, v in rates.items()) + f"; {smi}")
    return rates


def phase_conv_types(counters, train_counters, smi: str, vanilla_s: dict,
                     vanilla_rates: dict) -> dict:
    """The conv-block library on the card (ROADMAP A.6, A.9): gated LAFC
    and FGT under each norm at the small reference's size, card against
    CPU; gated BN object removal at full width from JAX-layout
    directories; gated training (see :func:`conv_types_train`)."""
    t0 = time.perf_counter()
    for norm in (None, "BN", "IN", "SN"):
        phase_small_reference(conv_type="gated", norm=norm)
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        removal = conv_types_removal(counters, root, smi, vanilla_s)
        t2 = time.perf_counter()
        rates = conv_types_train(train_counters, root, smi, vanilla_rates)
    log(f"conv types phase: {time.perf_counter() - t0:.2f} s (small "
        f"references {t1 - t0:.2f} s, object removal {t2 - t1:.2f} s, "
        f"training {time.perf_counter() - t2:.2f} s)")
    return {"removal_s": removal, "steps_per_s": rates}


def phase_small_train(devices=("cuda", "cpu")):
    """One SGD GAN step at 64x64, 5 frames, FGT at 512 hidden / 4 heads
    (head dim 128, the kernels' width) with 2 blocks, f32: on the card
    (K2, K4, K5) and on the CPU (plain versions), from the same weights
    and batch. SGD with lr 1 makes each parameter delta the negative
    gradient. Losses must agree to 1e-4 relative; every tensor's delta
    to 1e-3 of its own largest |delta| plus 1e-5 of the largest delta
    of its model (tensors whose gradient is zero in exact arithmetic,
    such as the key bias, hold rounding noise only)."""
    import torch
    from fgt_tpu_torch.models import discriminator, fgt, lafc_single
    from fgt_tpu_torch.train.fgt_step import FGTTrainStep

    cfg = dict(train_opt("."), numBlocks=2, mlp_ratio=4, res_h=64, res_w=64)
    batch = synthetic_train_batch(b=1, t=5, h=64, w=64, seed=1)
    batch["masks"][:] = 0
    batch["masks"][:, :, 20:40, 16:44] = 1
    batch = {"frames": batch["frames"], "masks": batch["masks"],
             "flows": batch["forward_flo"]}
    results = []
    for dev in devices:
        gen_rng = torch.Generator().manual_seed(5)
        gen = fgt.init_fgt(fgt.Model(cfg), gen_rng)
        disc = discriminator.init_discriminator(
            discriminator.TemporalPatchGAN(3, 32), gen_rng)
        oracle = lafc_single.init_lafc_single(
            lafc_single.Model(cfg["flow_config"]), gen_rng)
        for m in (gen, disc, oracle):
            m.to(dev)
        oracle.eval().requires_grad_(False)
        before = {f"{tag}.{k}": p.detach().cpu().clone()
                  for tag, m in (("g", gen), ("d", disc))
                  for k, p in m.named_parameters()}
        step = FGTTrainStep(gen, disc, oracle,
                            torch.optim.SGD(gen.parameters(), lr=1.0),
                            torch.optim.SGD(disc.parameters(), lr=1.0))
        metrics = step({k: torch.from_numpy(v).to(dev)
                        for k, v in batch.items()})
        deltas = {f"{tag}.{k}": p.detach().cpu() - before[f"{tag}.{k}"]
                  for tag, m in (("g", gen), ("d", disc))
                  for k, p in m.named_parameters()}
        results.append(({k: float(v) for k, v in metrics.items()}, deltas))
    (m_gpu, d_gpu), (m_cpu, d_cpu) = results
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-6)
                   for k in m_cpu)
    top = {tag: max(v.abs().max().item() for k, v in d_cpu.items()
                    if k.startswith(tag)) for tag in ("g", "d")}
    worst, worst_key = 0.0, ""
    for k, want in d_cpu.items():
        tol = 1e-3 * want.abs().max().item() + 1e-5 * top[k[0]]
        ratio = (d_gpu[k] - want).abs().max().item() / tol
        if ratio > worst:
            worst, worst_key = ratio, k
    log(f"small train step: card vs CPU losses max rel err {loss_err:.3g} "
        f"(tol 1e-4); parameter deltas worst err/tol {worst:.3g} at "
        f"{worst_key}; gen_loss {m_gpu['gen_loss']:.6f} vs "
        f"{m_cpu['gen_loss']:.6f}")
    if not (loss_err <= 1e-4 and worst <= 1.0):
        raise AssertionError("card and CPU GAN steps disagree")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fgt_tpu_torch import native
    from fgt_tpu_torch.ops import (_build, corr_fused, corr_lookup,
                                   flash_attention)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    secs = _build.build_cuda_kernels()
    t0 = time.perf_counter()
    native._load()
    t1 = time.perf_counter()
    _build.load_host_library("jpeg_decode")
    log(f"build: CUDA kernels {secs:.2f} s, host flowNN library "
        f"{t1 - t0:.2f} s, host JPEG decoder {time.perf_counter() - t1:.2f} s")
    t0 = time.perf_counter()
    phase_jpeg_fixtures()
    log(f"phase_jpeg_fixtures: {time.perf_counter() - t0:.2f} s")
    resources = resource_usage()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1, k2, k3, k45 = {}, {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        phase_k1(dt, k1)
        phase_k2(dt, k2)
        phase_k45(dt, k45, resources)
        phase_k3(dt, k3)
    alt = k1[str(torch.float32)]["noisy"]
    log(f"K1 float32, the --alternate_corr contract (f32 features and "
        f"levels, C=256, r=4, the f32 body): kernel_ms {alt['ms']:.4f} "
        f"plain_ms {alt['plain_ms']:.4f} bound_ms {alt['bound_ms']:.4f} "
        f"({alt['bound_by']}), max_abs_err {alt['max_abs_err']:.3g}")
    phase_k1(torch.bfloat16, k1, C=128, r=3)     # RAFT --small
    phase_k3_small(k3)
    phase_pyramid_build()
    phase_refine_bf16()
    counters = (corr_fused.lookup_corr_fused, corr_lookup.lookup_corr_pyramid,
                flash_attention.flash_mhsa)
    launches, fused_s, fused_peak = phase_main_path(
        counters, "fused", {"lookup_corr_fused": 20, "lookup_corr_pyramid": 0,
                            "flash_mhsa": None})
    pyr_launches, pyr_s, _ = phase_main_path(
        counters, "pyramid", {"lookup_corr_fused": 0,
                              "lookup_corr_pyramid": 20, "flash_mhsa": None})
    log(f"s1 RAFT, warm, same run: K1 path {fused_s['s1_raft']:.4f} s, "
        f"pyramid path (K3) {pyr_s['s1_raft']:.4f} s")
    with tempfile.TemporaryDirectory() as root:
        phase_modes(counters, root)
        phase_flow_extract(counters, root)
        phase_batch(counters, root)
        phase_small(counters, root)
        phase_alternate(counters, root)
        phase_evaluate(counters, root)
        phase_debug_flags(counters, root)
        phase_jpeg_clip(counters, root)
        t0 = time.perf_counter()
        phase_dataset_prep(counters, root, smi, fused_s, fused_peak)
        log(f"phase_dataset_prep: {time.perf_counter() - t0:.2f} s")
        phase_checkpoints(counters, root, smi)
    train_counters = (flash_attention.flash_mhsa,
                      flash_attention.flash_attention_dq,
                      flash_attention.flash_attention_dkv)
    all_counters = (corr_fused.lookup_corr_fused,
                    corr_lookup.lookup_corr_pyramid, *train_counters)
    with tempfile.TemporaryDirectory() as stage_root:
        oracle, lafc_stats = phase_lafc_train(all_counters, counters,
                                              stage_root, smi)
        train_launches, fgt_stats = phase_train(
            train_counters, "--profile" in sys.argv, oracle)
    with tempfile.TemporaryDirectory() as cli_root:
        cli = phase_cli_train(all_counters, cli_root, smi)
    with tempfile.TemporaryDirectory() as cli_root:
        cli_jpg = phase_cli_train(all_counters, cli_root, smi, fmt="jpg")
    t0 = time.perf_counter()
    phase_sustained_train(all_counters, smi)
    log(f"phase_sustained_train: {time.perf_counter() - t0:.2f} s")
    log("training from disk, JPEG tree vs PNG tree: " + "; ".join(
        f"{m} {cli_jpg[m]['steps_per_s']:.4f} vs {cli[m]['steps_per_s']:.4f} "
        f"steps/s, loader " + ", ".join(
            f"{w} workers {cli_jpg[m]['items_per_s'][w]:.3f} vs "
            f"{cli[m]['items_per_s'][w]:.3f}" for w in cli[m]['items_per_s'])
        + " items/s" for m in cli) + f"; {smi}")
    on_card = {"lafc_single": lafc_stats[True]["steps_per_s"],
               "lafc": lafc_stats[False]["steps_per_s"],
               "model": fgt_stats["steps_per_s"]}
    log("training steps/s, from disk through the CLI vs on a batch made on "
        "the card: " + "; ".join(
            f"{m} {cli[m]['steps_per_s']:.4f} vs {on_card[m]:.4f}"
            for m in on_card) + f"; {smi}")
    with tempfile.TemporaryDirectory() as dp_root:
        phase_dp_train(all_counters, dp_root, smi, cli)
    with tempfile.TemporaryDirectory() as par_root:
        phase_parallel(all_counters, par_root, smi)
    with tempfile.TemporaryDirectory() as gate_root:
        phase_overfit_gate(all_counters, gate_root, smi)
    phase_conv_types(counters, train_counters, smi, fused_s, on_card)
    phase_small_reference()
    phase_small_reference("pyramid", use_nonlocal=True)
    phase_small_reference(small=True)
    phase_small_train()
    phase_small_lafc_train()

    bf16 = str(torch.bfloat16)
    kernels = [
        dict(name="corr_fused_lookup", route="cuda",
             source="fgt_tpu_torch/csrc/corr_fused.cu",
             replaces="fgt_tpu/ops/corr_fused_pallas.py:65",
             launches=launches["lookup_corr_fused"], **k1[bf16]["smooth"]),
        dict(name="flash_attention_forward", route="cuda",
             source="fgt_tpu_torch/csrc/flash_attention.cu",
             replaces="fgt_tpu/ops/flash_attention.py:33",
             launches=launches["flash_mhsa"], **k2[bf16]),
        dict(name="corr_lookup_pyramid", route="cuda",
             source="fgt_tpu_torch/csrc/corr_lookup.cu",
             replaces="fgt_tpu/ops/corr_lookup_pallas.py:43",
             launches=pyr_launches["lookup_corr_pyramid"],
             **k3[bf16]["bf16"]),
        dict(name="flash_attention_dq", route="cuda",
             source="fgt_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="fgt_tpu/ops/flash_attention.py:73",
             launches=train_launches["flash_attention_dq"],
             **k45["dq"][bf16]),
        dict(name="flash_attention_dkv", route="cuda",
             source="fgt_tpu_torch/csrc/flash_attention_bwd.cu",
             replaces="fgt_tpu/ops/flash_attention.py:105",
             launches=train_launches["flash_attention_dkv"],
             **k45["dkv"][bf16]),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
