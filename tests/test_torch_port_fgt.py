"""FGT in the PyTorch port vs the JAX package, on the CPU, in f32:

* kernel K2's plain version against the flash Pallas kernel in
  interpret mode (L = 128 and 300, head dim 128);
* TMHSA (which reaches K2) and FlowGuidedSWMHSA;
* the FGT generator at a tiny width;
* the s6 driver (batched windows + ordered 50/50 composite) against the
  JAX pipeline's device program ``Models.fgt_scan``.
Weights move through ``convert.weights.jax_to_torch_state``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.ops.attention import TMHSA as JaxTMHSA
from fgt_tpu.ops.attention import FlowGuidedSWMHSA as JaxSWMHSA
from fgt_tpu.ops.flash_attention import flash_mhsa as jax_flash_mhsa
from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.ops import attention as tatt
from fgt_tpu_torch.ops import flash_attention as tflash
from fgt_tpu_torch.pipeline import video_inpainting as tvi

torch.set_num_threads(1)

TINY_FGT = {
    "model": "model", "in_channel": 4, "cnum": 8, "flow_inChannel": 2,
    "flow_cnum": 8, "frame_hidden": 32, "flow_hidden": 16, "PASSMASK": 1,
    "numBlocks": 4, "num_head": 4, "conv_type": "vanilla", "norm": None,
    "use_bias": 1, "ape": 1, "mlp_ratio": 2, "drop": 0, "tw": 2, "sw": 4,
    "gd": 2, "kernel_size_w": 7, "kernel_size_h": 7, "stride_h": 3,
    "stride_w": 3, "pad_h": 3, "pad_w": 3, "res_h": 64, "res_w": 64,
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,l", [(2, 128), (3, 300)])
def test_k2_plain_matches_pallas_interpret(n, l):
    """f32; tolerance 2e-5 (online vs one-shot softmax reassociation, as
    tests/test_flash_attention.py). The plain version also returns the
    row logsumexp the kernel keeps for the backward."""
    rng = np.random.RandomState(l)
    q, k, v = (rng.randn(n, l, 128).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(128)
    want = np.asarray(jax_flash_mhsa(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), scale=scale,
                                     interpret=True))
    out, lse = tflash.flash_mhsa(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)
    s = np.einsum("nqc,nkc->nqk", q.astype(np.float64), k) * scale
    lse_ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-4)


def _state(variables, mapping):
    return weights.jax_to_torch_state(
        jax.tree_util.tree_map(np.asarray, variables), mapping)


def test_tmhsa_matches_jax_flash():
    """TMHSA through K2's plain version vs the JAX module with its flash
    kernel (interpret mode); ragged cells (h, w not multiples of the
    group) included. f32, tolerance 2e-5."""
    rng = np.random.RandomState(2)
    t, h, w, c = 3, 7, 11, 64
    x = rng.randn(2 * t, h * w, c).astype(np.float32)
    jm = JaxTMHSA(d_model=c, group_size=2, num_heads=4, use_flash=True)
    variables = jax.jit(lambda r, a: jm.init(r, a, t, h, w))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x), t, h, w))
    mapping = {}
    for ours, theirs in (("query", "query_embedding"),
                         ("key", "key_embedding"),
                         ("value", "value_embedding"),
                         ("out", "output_linear")):
        mapping.update(weights._linear(("params", ours), theirs))
    port = tatt.TMHSA(c, 2, 4)
    weights.load_state(port, _state(variables, mapping))
    with torch.no_grad():
        got = port(_t(x), t, h, w).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_flow_guided_swmhsa_matches_jax():
    """Spatial window attention with global tokens, padded windows
    (h, w not multiples of the window). f32, tolerance 2e-5."""
    rng = np.random.RandomState(3)
    bt, h, w, c, cf = 2, 10, 13, 32, 16
    x = rng.randn(bt, h * w, c).astype(np.float32)
    f = rng.randn(bt, h * w, cf).astype(np.float32)
    jm = JaxSWMHSA(d_model=c, flow_d_model=cf, window_size=4,
                   global_stride=2, num_heads=4)
    variables = jax.jit(lambda r, a, b: jm.init(r, a, b, h, w))(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(f))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # LayerNorms at identity would hide a mismatch: randomize them
    for nm in ("q_norm", "k_norm", "v_norm"):
        for leaf in ("scale", "bias"):
            a = variables["params"][nm][leaf]
            variables["params"][nm][leaf] = (
                rng.randn(*a.shape) * 0.3 + (leaf == "scale")).astype(
                    np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), jnp.asarray(f),
                               h, w))
    full = weights._transformer_s(("params",), "blk")
    att = {(p[0],) + p[2:]: (k[len("blk.attention."):], kind)
           for p, (k, kind) in full.items() if p[1] == "attention"}
    port = tatt.FlowGuidedSWMHSA(c, cf, 4, 2, 4)
    weights.load_state(port, _state(variables, att))
    with torch.no_grad():
        got = port(_t(x), _t(f), h, w).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def fgt_pair():
    model = JaxFGT(config=TINY_FGT)
    shape = (1, 2, 64, 64)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros(shape + (3,)),
        jnp.zeros(shape + (2,)), jnp.zeros(shape + (1,)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = tfgt.Model(TINY_FGT).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.fgt_mapping(TINY_FGT["numBlocks"])))
    return model, variables, port


def test_fgt_model_matches_jax(fgt_pair):
    """Tiny FGT (2 temporal + 2 spatial blocks), 5 frames at 64x64 with a
    non-multiple token grid. f32; tolerance 1e-4 on the tanh output."""
    model, variables, port = fgt_pair
    rng = np.random.RandomState(4)
    shape = (1, 5, 64, 64)
    frames = rng.uniform(-1, 1, shape + (3,)).astype(np.float32)
    flows = rng.randn(*shape, 2).astype(np.float32)
    masks = (rng.rand(*shape, 1) > 0.8).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(frames),
                                  jnp.asarray(flows), jnp.asarray(masks)))
    with torch.no_grad():
        got = port(_t(frames), _t(flows), _t(masks)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _jax_models_shell(model, variables, config):
    """The JAX pipeline's Models with only what its s6 program reads."""
    m = jvi.Models.__new__(jvi.Models)
    m.fgt_model, m.fgt_vars, m.fgt_config = model, variables, dict(config)
    m.dtype = jnp.float32
    m._jit_cache, m._variant_cache = {}, {}
    return m


def test_s6_fgt_synthesis_matches_jax_scan(fgt_pair):
    """The s6 driver against the JAX device program (fgt_scan): fixed
    windows, batch 2 (so windows span batches), ordered 50/50 composite,
    trunc-cast u8. Outside the mask the input bytes come back exactly;
    inside, at most 1 LSB (f32 reassociation can move a value across an
    integer before the trunc-cast)."""
    model, variables, port = fgt_pair
    rng = np.random.RandomState(5)
    n, h, w = 8, 64, 64
    video = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        masks[i, 20:36, 16 + 2 * i:40 + 2 * i] = 1
    flows = rng.randn(n - 1, h, w, 2).astype(np.float32)
    ids_mat, t_n = jvi.fgt_window_ids(n, 3, 4, -1)
    ids_k = jvi._scan_chunks(ids_mat.astype(np.int32), 2)
    jm = _jax_models_shell(model, variables, TINY_FGT)
    want = np.asarray(jm.fgt_scan(False)(
        variables, jnp.asarray(video), jnp.asarray(masks[..., None]),
        jnp.asarray(flows), jnp.asarray(ids_k), np.int32(ids_mat.shape[0]),
        t_n))
    models = tvi.Models.__new__(tvi.Models)
    models.fgt, models.dtype = port, torch.float32
    with torch.no_grad():
        got = tvi.fgt_synthesis(models, _t(video), _t(masks), _t(flows),
                                neighbor_stride=3, step=4, window_batch=2
                                ).numpy()
    out = masks == 0
    np.testing.assert_array_equal(got[out], video[out])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
