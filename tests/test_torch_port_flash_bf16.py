"""Flash attention in bf16: the plain versions of kernels K2, K4 and K5
against the JAX package's flash kernels (Pallas, interpret mode) on the
CPU.

The TPU kernels round p, and ds in the backward, to the input dtype
before the second product of each pair (p·v, ds·k, pᵀ·dO, dsᵀ·q) and
keep every sum in f32; the plain versions, which the CUDA kernels are
held to on the card, must round at the same places. Inputs are bf16
values made with numpy; both sides see the same bf16 tensors.

Tolerance, with its reason: the two sides run the same roundings but sum
in other orders (XLA's dot and exp against torch's), so an entry can
differ only where that f32 reassociation tips a p, a ds or the output
across a bf16 rounding boundary. So at most 1% of the entries may differ
at all, and none by more than one bf16 ulp of the largest entry
(top·2⁻⁷). Leaving p and ds unrounded makes more than a quarter of them
differ (pinned below), so the 1% bound tells the two apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.ops.flash_attention import flash_mhsa as jax_flash_mhsa
from fgt_tpu_torch.ops import flash_attention as tflash

torch.set_num_threads(1)
SCALE = 128 ** -0.5


def _bf16_inputs(seed: int, count: int, n: int, l: int) -> list:
    """``count`` [n, l, 128] arrays of bf16 values (as f32 numpy)."""
    rng = np.random.RandomState(seed)
    return [np.array(jnp.asarray(rng.randn(n, l, 128), jnp.bfloat16)
                     .astype(jnp.float32)) for _ in range(count)]


def _jax(a):
    return jnp.asarray(a, jnp.bfloat16)


def _torch(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _assert_bf16_close(got: np.ndarray, want: np.ndarray):
    diff = np.abs(got - want)
    top = np.abs(want).max()
    assert diff.max() <= top * 2 ** -7, (diff.max(), top)
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()


@pytest.mark.parametrize("l", [10, 130, 300])
def test_k2_plain_bf16_matches_pallas_interpret(l):
    """One JAX key block covers every row at these L (blocks of up to
    512), so both sides compute p = exp(s − rowmax) once per row. The
    lse, which JAX keeps to itself, is held to a float64 logsumexp of
    the same bf16 inputs (1e-4)."""
    q, k, v = _bf16_inputs(l, 3, 2, l)
    want = np.asarray(jax_flash_mhsa(_jax(q), _jax(k), _jax(v), scale=SCALE,
                                     interpret=True).astype(jnp.float32))
    out, lse = tflash.flash_mhsa(_torch(q), _torch(k), _torch(v), SCALE)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_bf16_close(out.float().numpy(), want)
    s = np.einsum("nqc,nkc->nqk", q.astype(np.float64), k) * SCALE
    lse_ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-4)


@pytest.mark.parametrize("l", [10, 300])
def test_k45_plain_bf16_matches_jax_flash_grad(l):
    """dq, dk, dv from the plain versions of K4/K5 (fed the plain K2's
    lse and dsum = rowsum(dO∘O) of its bf16 output, as the JAX backward
    takes it) against jax.grad through the Pallas kernels in interpret
    mode, whose cotangent is the same bf16 dO."""
    q, k, v, do = _bf16_inputs(l + 1, 4, 2, l)

    def loss(q_, k_, v_):
        out = jax_flash_mhsa(q_, k_, v_, scale=SCALE, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(_jax(q), _jax(k), _jax(v))
    tq, tk, tv, tdo = (_torch(a) for a in (q, k, v, do))
    out, lse = tflash.flash_mhsa(tq, tk, tv, SCALE)
    dsum = (tdo.float() * out.float()).sum(-1)
    dq = tflash.flash_attention_dq(tq, tk, tv, tdo, lse, dsum, SCALE)
    dk, dv = tflash.flash_attention_dkv(tq, tk, tv, tdo, lse, dsum, SCALE)
    for got, exp in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        _assert_bf16_close(got.float().numpy(),
                           np.asarray(exp.astype(jnp.float32)))


@pytest.mark.parametrize("l", [130, 300])
def test_bf16_tolerance_rejects_unrounded_p(l):
    """The tolerance above has teeth: the forward computed with p kept in
    f32 for p·v (what the port did before) differs from the Pallas kernel
    in more than a quarter of the entries."""
    q, k, v = _bf16_inputs(l, 3, 2, l)
    want = np.asarray(jax_flash_mhsa(_jax(q), _jax(k), _jax(v), scale=SCALE,
                                     interpret=True).astype(jnp.float32))
    s = torch.einsum("nqc,nkc->nqk", *(torch.from_numpy(a) for a in (q, k)))
    p = torch.softmax(s * SCALE, dim=-1)
    unrounded = torch.einsum("nqk,nkc->nqc", p, torch.from_numpy(v))
    diff = np.abs(unrounded.to(torch.bfloat16).float().numpy() - want)
    assert (diff > 0).mean() > 0.25
