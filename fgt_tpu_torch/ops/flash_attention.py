"""Flash attention for FGT's temporal window attention — kernels K2
(forward), K4 (dq) and K5 (dk, dv).

Replaces the TPU kernels of ``fgt_tpu/ops/flash_attention.py``:
``_flash_kernel`` (forward, called through ``flash_mhsa``) and the two
kernels of its custom VJP, ``_flash_dq_kernel`` and ``_flash_dkv_kernel``.
The forward computes softmax(q·kᵀ·scale)·v over [N, L, ch] with
N = batch·groups·heads, plus the f32 row logsumexp (lse) that the
backward recomputes the probabilities from. :class:`FlashAttention`
ties the three together as one differentiable op; :func:`flash_attend`,
which TMHSA calls, goes through it.

Rounding. Scores, softmax statistics and every sum are f32. In bf16, as
in the TPU kernels, p (and ds in the backward) is rounded to the input
dtype before the second product of each pair: p·v (K2), ds·k (K4),
pᵀ·dO and dsᵀ·q (K5); the row sum l and ds take the unrounded p. The
plain versions round at the same places; in f32 nothing is rounded.

Design for Hopper. Each kernel handles the ragged end of L itself
(masked keys, masked query rows), so no padding to a block multiple
reaches device memory, and each output row belongs to one block, so the
backward uses no atomics and is deterministic. Head dim 128 only (the
FGT path: 512 hidden / 4 heads). The C entry points dispatch on dtype:

* bf16, tensor cores (``mma.sync`` m16n8k16, f32 accumulation; shared
  helpers in ``csrc/mma_bf16.cuh``). Tiles stay bf16 in swizzled shared
  memory (16-byte chunks XORed with the row, so ``ldmatrix`` is free of
  bank conflicts) and stream through a two-stage ring of 16-byte
  ``cp.async`` copies, the next tile in flight while this one's products
  run.

  - K2 (``csrc/flash_attention.cu``): one block of 4 warps per (n,
    64-query tile), 16 query rows a warp with their q fragments held in
    registers; 64-key k/v tiles; online softmax on the accumulators
    (scale·log2e folded into ``exp2f``); p goes from the score
    accumulators to bf16 A fragments in registers, v's B fragments come
    from ``ldmatrix.trans``. 80 KB of shared memory, two blocks an SM.
  - K5 (``csrc/flash_attention_bwd.cu``): one block of 8 warps per (n,
    64-key tile) holding k and v for its life; per 64-query tile,
    sᵀ = k·qᵀ and dpᵀ = v·dOᵀ (a warp: 16 keys × 32 queries), pᵀ and dsᵀ
    rounded to bf16 through shared memory, then dv += pᵀ·dO and
    dk += dsᵀ·q (a warp: 16 keys × 64 head-dim columns, 64 f32
    accumulators a lane). 113 KB of shared memory.
  - K4 (``csrc/flash_attention_bwd.cu``): K2's loop shape, one block of
    4 warps per (n, 64-query tile), 16 query rows a warp; q and dO stay
    in shared memory (held in registers beside dq, s and dp they would
    pass 255 registers a lane); per 64-key tile, s = q·kᵀ and dp = dO·vᵀ,
    p in f32, ds rounded to bf16 into A fragments in registers, then
    dq += ds·k with k's B fragments from ``ldmatrix.trans``. 96 KB of
    shared memory, two blocks an SM.
* f32, full f32 on the FMA units (TF32 would round the operands): 64-row
  tiles staged in shared memory as f32, 256 threads per block, each
  owning a 4×4 micro-tile of the 64×64 score tile.

  - K2: one block per (n, 64-query tile); online softmax with the
    running max and sum in f32 registers.
  - K4: one block per (n, 64-query tile); loops over key tiles:
    s = q·kᵀ·scale, p = exp(s − lse), dp = dO·vᵀ, ds = p∘(dp − dsum)·scale,
    dq += ds·k.
  - K5: one block per (n, 64-key tile); loops over query tiles:
    dv += pᵀ·dO, dk += dsᵀ·q, the accumulators in registers.

dsum = rowsum(dO∘O) is taken in plain torch, as the JAX package takes it
outside Pallas.

Bounds on the card (H100 SXM). Forward at inference's N = 80,
L = 2340: 4·N·L²·ch ≈ 224 GFLOP against ≈0.2 GB, operations-bound,
≈0.23 ms at the bf16 tensor-core peak (989 TFLOP/s). Backward at
training's N = 32, L = 900: K4 does 6·N·L²·ch ≈ 19.9 GFLOP (≈0.020 ms
bf16 bound), K5 8·N·L²·ch ≈ 26.5 GFLOP (≈0.027 ms), both
operations-bound. ``mma.sync`` reaches only part of that peak
(``wgmma`` is the further step); the f32 bodies are held to the f32
FMA peak (67 TFLOP/s).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fgt_tpu_torch.ops._build import check_launch, load_cuda_library

HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel(lib: str, name: str, n_ptrs: int):
    fn = getattr(load_cuda_library(lib), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_float, ctypes.c_int,
                                                ctypes.c_void_p]
    return fn


def _check(name: str, q: torch.Tensor, *same: torch.Tensor) -> None:
    """Raise unless ``q`` and ``same`` are CUDA [N, L, 128] tensors of one
    supported dtype and shape."""
    if not q.is_cuda:
        raise RuntimeError(f"{name}: CUDA tensors expected")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in same):
        raise TypeError(f"{name}: unsupported dtypes "
                        f"{[str(t.dtype) for t in (q,) + same]}")
    if q.dim() != 3 or any(t.shape != q.shape for t in same):
        raise ValueError(f"{name}: operands must share one [N, L, ch] "
                         f"shape, got {[tuple(t.shape) for t in (q,) + same]}")
    if q.shape[2] != HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[2]} != {HEAD_DIM}")


def _rows(name: str, ref: torch.Tensor, *rows: torch.Tensor) -> list:
    """The [N, L] f32 row vectors (lse, dsum), checked and contiguous."""
    for r in rows:
        if r.dtype != torch.float32 or r.shape != ref.shape[:2] or \
                r.device != ref.device:
            raise ValueError(f"{name}: row vectors must be f32 "
                             f"{tuple(ref.shape[:2])} on {ref.device}")
    return [r.contiguous() for r in rows]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------- plain

def _as_input(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to ``like``'s dtype and back (a no-op in f32): the
    TPU kernels' ``p.astype(v.dtype)`` / ``ds.astype(k.dtype)`` before the
    second product of each pair."""
    return x.to(like.dtype).float()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float):
    """Plain PyTorch version of K2: (out [N, L, ch] in q's dtype,
    lse [N, L] f32). In bf16, what ``_flash_kernel`` computes when one
    key block covers the row: p = exp(s − rowmax) in f32, l = the f32 sum
    of the unrounded p, out = (p rounded to bf16)·v accumulated in f32,
    divided by l. In f32 nothing is rounded, and out = exp(s − lse)·v
    takes the very p that the backward recomputes from lse, so that the
    sums of ds that vanish in exact arithmetic hold the least noise."""
    s = torch.einsum("nqc,nkc->nqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    if q.dtype == torch.float32:
        out = torch.einsum("nqk,nkc->nqc", torch.exp(s - lse[..., None]),
                           v.float())
    else:
        # the gradient through the max cancels exactly: leave it out
        p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
        out = torch.einsum("nqk,nkc->nqc", _as_input(p, v),
                           v.float()) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype), lse


def _probs_and_ds(q, k, v, dout, lse, dsum, scale):
    """p = exp(q·kᵀ·scale − lse) and ds = p∘(dO·vᵀ − dsum)·scale in f32,
    recomputed as the TPU backward kernels recompute them (ds from the
    unrounded p)."""
    s = torch.einsum("nqc,nkc->nqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("nqc,nkc->nqk", dout.float(), v.float())
    return p, p * (dp - dsum[..., None]) * scale


def flash_attention_dq_plain(q, k, v, dout, lse, dsum, scale: float):
    """Plain PyTorch version of K4: dq = ds·k, ds rounded to the input
    dtype, in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, dsum, scale)
    return torch.einsum("nqk,nkc->nqc", _as_input(ds, k),
                        k.float()).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, dout, lse, dsum, scale: float):
    """Plain PyTorch version of K5: (dk = dsᵀ·q, dv = pᵀ·dO), p and ds
    rounded to the input dtype, in the input dtype."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, dsum, scale)
    dk = torch.einsum("nqk,nqc->nkc", _as_input(ds, q), q.float())
    dv = torch.einsum("nqk,nqc->nkc", _as_input(p, dout), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------- wrappers

def flash_mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float):
    """K2: softmax(q kᵀ scale) v over [N, L, ch]. Returns (out, lse). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise). Not differentiable on CUDA: use :class:`FlashAttention`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check("flash_mhsa", q, k, v)
    n, l, _ = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(n, l, dtype=torch.float32, device=q.device)
    err = _kernel("flash_attention", "flash_attention_forward", 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), n, l, float(scale), _DTYPE_CODE[q.dtype], _stream(q))
    check_launch(err, "flash_attention_forward")
    flash_mhsa.launches += 1
    return out, lse


flash_mhsa.launches = 0


def flash_attention_dq(q, k, v, dout, lse, dsum, scale: float):
    """K4: dq [N, L, ch] in q's dtype from the saved lse and
    dsum = rowsum(dO∘O). CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, dout, lse, dsum, scale)
    _check("flash_attention_dq", q, k, v, dout)
    lse, dsum = _rows("flash_attention_dq", q, lse, dsum)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    n, l, _ = q.shape
    dq = torch.empty_like(q)
    err = _kernel("flash_attention_bwd", "flash_attention_dq", 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), n, l, float(scale),
        _DTYPE_CODE[q.dtype], _stream(q))
    check_launch(err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, dout, lse, dsum, scale: float):
    """K5: (dk, dv) [N, L, ch] in the input dtype from the saved lse and
    dsum. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, dout, lse, dsum, scale)
    _check("flash_attention_dkv", q, k, v, dout)
    lse, dsum = _rows("flash_attention_dkv", q, lse, dsum)
    q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
    n, l, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _kernel("flash_attention_bwd", "flash_attention_dkv", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(), n, l,
        float(scale), _DTYPE_CODE[q.dtype], _stream(q))
    check_launch(err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over [N, L, ch]: K2 forward, K4 and
    K5 backward (plain versions for CPU tensors) — the JAX package's
    ``_flash_core`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_mhsa(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        dsum = (dout.float() * out.float()).sum(-1)
        dq = flash_attention_dq(q, k, v, dout, lse, dsum, ctx.scale)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, dsum, ctx.scale)
        return dq, dk, dv, None


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Attention over [..., L, ch] operands: collapses the leading dims
    into N, runs :class:`FlashAttention`, restores the shape."""
    lead = q.shape[:-2]
    l, ch = q.shape[-2:]
    n = math.prod(lead) if lead else 1
    out = FlashAttention.apply(q.reshape(n, l, ch), k.reshape(n, l, ch),
                               v.reshape(n, l, ch), scale)
    return out.reshape(*lead, l, ch)
