"""Forward flash attention for FGT's temporal window attention — kernel K2.

Replaces the TPU kernel ``fgt_tpu/ops/flash_attention.py::_flash_kernel``
(forward, called through ``flash_mhsa``): softmax(q·kᵀ·scale)·v over
[N, L, ch] with N = batch·groups·heads, plus the f32 row logsumexp kept
for a later backward. The backward kernels (``_flash_dq_kernel``,
``_flash_dkv_kernel``) serve training only and are not ported here.

Design for Hopper (``csrc/flash_attention.cu``): one block of 256
threads per (n, 64-query tile); q, k, v tiles of 64 rows × 128 staged in
shared memory as f32 (~115 KB, dynamic shared memory); 4×4 score and 4×8
output micro-tiles per thread; running max and sum in f32 registers
(online softmax); keys past the ragged end of L masked to -1e30 in the
kernel, so no padding to a block multiple ever reaches device memory.
Head dim 128 only (the FGT main path: 512 hidden / 4 heads).

Bound on the card: at the main path's N = 80, L = 2340, ch = 128 the
call does 4·N·L²·ch ≈ 224 GFLOP and must move ≈0.2 GB, so operations
bound it — ≈0.23 ms at the bf16 tensor-core peak (989 TFLOP/s). This
first kernel runs the products on the f32 FMA units (67 TFLOP/s peak)
and so cannot come near that bound; moving them onto ``mma``/``wgmma``
is later work.
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
def _kernel():
    fn = load_cuda_library("flash_attention").flash_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    return fn


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float):
    """Plain PyTorch version of K2: (out [N, L, ch] in q's dtype,
    lse [N, L] f32), computed in f32."""
    s = torch.einsum("nqc,nkc->nqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("nqk,nkc->nqc", p, v.float())
    return out.to(q.dtype), lse


def flash_mhsa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float):
    """softmax(q kᵀ scale) v over [N, L, ch]. Returns (out, lse). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if not q.is_cuda:
        raise RuntimeError("flash_mhsa: CUDA tensors expected")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mhsa: unsupported dtypes "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_mhsa: q/k/v must share one [N, L, ch] "
                         f"shape, got {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    n, l, ch = q.shape
    if ch != HEAD_DIM:
        raise ValueError(f"flash_mhsa: head dim {ch} != {HEAD_DIM}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(n, l, dtype=torch.float32, device=q.device)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), lse.data_ptr(), n, l, float(scale),
                    _DTYPE_CODE[q.dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(err, "flash_attention_forward")
    flash_mhsa.launches += 1
    return out, lse


flash_mhsa.launches = 0


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Attention over [..., L, ch] operands: collapses the leading dims
    into N, runs :func:`flash_mhsa`, restores the shape."""
    lead = q.shape[:-2]
    l, ch = q.shape[-2:]
    n = math.prod(lead) if lead else 1
    out, _ = flash_mhsa(q.reshape(n, l, ch), k.reshape(n, l, ch),
                        v.reshape(n, l, ch), scale)
    return out.reshape(*lead, l, ch)
