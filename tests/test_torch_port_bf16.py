"""The port's modules in bf16 against the JAX package's, on the CPU.

The f32 tests pin the port to the JAX package; these bound what bf16 adds.
Both sides run bf16 as their pipelines run it: the JAX package casts the
f32 parameters and the inputs to bf16 (``Models`` in
``fgt_tpu/pipeline/video_inpainting.py``), the port moves its modules to
bf16. The two round in different places (XLA against PyTorch's CPU
kernels, the update block's fused ops), so neither run is the other's
reference; the JAX package's own bf16 deviation is the yardstick:

    max |port_bf16 - jax_bf16| <= 2 * max |jax_bf16 - jax_f32|

with both maxima over the module's output, taken relative to the largest
f32 output. Modules: RAFT refine on both correlation paths (the all-pairs
pyramid with K3's plain version, and K1's), LAFC, and FGT with its flash
temporal attention (K2's plain version). The whole slice and one bf16 SGD
GAN step are held to the same rule in ``test_torch_port_pipeline.py`` and
``test_torch_port_train.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.models.lafc import Model as JaxLAFC
from fgt_tpu.models.raft import RAFT, RAFTConfig
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc as tlafc
from fgt_tpu_torch.models import raft as traft
from test_torch_port_pipeline import _video

torch.set_num_threads(1)

LAFC_CFG = {"model": "lafc", "num_flows": 3, "flow_interval": 3, "cnum": 8,
            "in_channel": 3, "PASSMASK": 1, "use_residual": 1,
            "resBlocks": 1, "use_bias": 1, "conv_type": "vanilla",
            "use_edges": 0}
FGT_CFG = {
    "model": "model", "in_channel": 4, "cnum": 8, "flow_inChannel": 2,
    "flow_cnum": 8, "frame_hidden": 32, "flow_hidden": 16, "PASSMASK": 1,
    "numBlocks": 2, "num_head": 4, "conv_type": "vanilla", "norm": None,
    "use_bias": 1, "ape": 1, "mlp_ratio": 2, "drop": 0, "tw": 2, "sw": 4,
    "gd": 2, "kernel_size_w": 7, "kernel_size_h": 7, "stride_h": 3,
    "stride_w": 3, "pad_h": 3, "pad_w": 3, "res_h": 64, "res_w": 64,
    "use_flash": 1,
}


def bf16_tree(tree):
    """The JAX pipeline's cast: every f32 leaf to bf16."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == np.float32 else x,
        tree)


def assert_within_jax_bf16_spread(port_bf16, jax_bf16, jax_f32, label=""):
    """max |port_bf16 - jax_bf16| <= 2 max |jax_bf16 - jax_f32|, both
    relative to the largest |jax_f32|; the JAX deviation must be nonzero
    (the bf16 runs really rounded)."""
    port_bf16, jax_bf16, jax_f32 = (np.asarray(a, np.float64) for a in
                                    (port_bf16, jax_bf16, jax_f32))
    top = np.abs(jax_f32).max()
    port_dev = np.abs(port_bf16 - jax_bf16).max() / top
    jax_dev = np.abs(jax_bf16 - jax_f32).max() / top
    assert 0 < jax_dev and port_dev <= 2 * jax_dev, (label, port_dev, jax_dev)


@pytest.fixture(scope="module")
def raft_pair():
    video = _video(2, 64, 64, seed=0)[0].astype(np.float32)
    model = RAFT(RAFTConfig(iters=4))
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, iters=1))(
        jax.random.PRNGKey(0), jnp.asarray(video[:1]),
        jnp.asarray(video[1:]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = traft.RAFT().eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.raft_mapping()))
    return variables, port, video


def _jax_flow(variables, video, corr, dtype):
    """The JAX pipeline's s1 on one pair: frames and parameters in
    ``dtype``, encode, then 4 GRU iterations (pyramid in bf16 storage
    under bf16; ``fused``: the fused Pallas lookup in interpret mode)."""
    bf16 = dtype == jnp.bfloat16
    model = RAFT(RAFTConfig(iters=4, fused_corr=corr == "fused",
                            corr_dtype="bfloat16" if bf16 else "float32"))
    v = bf16_tree(variables) if bf16 else variables

    @jax.jit
    def run(v, video):
        fmap, net, inp = model.apply(v, video, method="encode")
        return model.apply(v, fmap[:1], fmap[1:], net[:1], inp[:1], iters=4,
                           method="refine")[1]

    return np.asarray(run(v, jnp.asarray(video, dtype)).astype(jnp.float32))


@pytest.mark.parametrize("corr", ["pyramid", "fused"])
def test_raft_refine_bf16_within_jax_spread(raft_pair, corr):
    """RAFT (encode + 4 GRU iterations) on a 64x64 pair of the pipeline
    tests' panning clip, bf16:
    the port's upsampled flow on each correlation path against the JAX
    package's (bf16 pyramid: K3's plain version hands bf16 taps to the
    update block, the f32 taps rounded once)."""
    variables, port, video = raft_pair
    want32 = _jax_flow(variables, video, corr, jnp.float32)
    want16 = _jax_flow(variables, video, corr, jnp.bfloat16)
    model = copy.deepcopy(port).to(torch.bfloat16)
    with torch.no_grad():
        fmap, net, inp = model.encode(torch.from_numpy(video))
        got = model.refine(fmap[:1], fmap[1:], net[:1], inp[:1], 4,
                           corr=corr)[1].float().numpy()
    assert got.shape == want16.shape == (1, 64, 64, 2)
    assert_within_jax_bf16_spread(got, want16, want32, corr)


def test_lafc_bf16_within_jax_spread():
    """LAFC (P3D completion net) on 2 windows of 3 smooth flows at 32x48
    with 30% holes, bf16: the completed flow."""
    model = JaxLAFC(config=LAFC_CFG)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 48, 2)),
        jnp.zeros((1, 3, 32, 48, 1))))
    port = tlafc.Model(LAFC_CFG).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.lafc_mapping(1)))
    rng = np.random.RandomState(0)
    flows = scipy.ndimage.uniform_filter(
        rng.randn(2, 3, 32, 48, 2).astype(np.float32) * 4,
        size=(1, 1, 7, 7, 1))
    masks = (rng.rand(2, 3, 32, 48, 1) > 0.7).astype(np.float32)
    apply = jax.jit(model.apply)
    want32 = np.asarray(apply(variables, jnp.asarray(flows),
                              jnp.asarray(masks))[0])
    want16 = np.asarray(apply(
        bf16_tree(variables), jnp.asarray(flows, jnp.bfloat16),
        jnp.asarray(masks, jnp.bfloat16))[0].astype(jnp.float32))
    port = port.to(torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(flows).to(torch.bfloat16),
                   torch.from_numpy(masks).to(torch.bfloat16))[0]
    assert_within_jax_bf16_spread(got.float().numpy(), want16, want32)


def test_fgt_bf16_within_jax_spread():
    """Tiny FGT (1 temporal + 1 spatial block pair, flash temporal
    attention as the pipeline runs it) on 5 frames at 64x64, bf16: the
    tanh output."""
    model = JaxFGT(config=FGT_CFG)
    shape = (1, 5, 64, 64)
    init = JaxFGT(config=dict(FGT_CFG, use_flash=0)).init  # the same tree
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(init)(
        jax.random.PRNGKey(0), jnp.zeros(shape + (3,)),
        jnp.zeros(shape + (2,)), jnp.zeros(shape + (1,))))
    port = tfgt.Model(FGT_CFG).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.fgt_mapping(FGT_CFG["numBlocks"])))
    rng = np.random.RandomState(4)
    frames = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    flows = rng.randn(*shape, 2).astype(np.float32)
    masks = (rng.rand(*shape, 1) > 0.8).astype(np.float32)
    apply = jax.jit(model.apply)
    want32 = np.asarray(apply(variables, *(jnp.asarray(a) for a in
                                           (frames, flows, masks))))
    want16 = np.asarray(apply(
        bf16_tree(variables), *(jnp.asarray(a, jnp.bfloat16) for a in
                                (frames, flows, masks))).astype(jnp.float32))
    port = port.to(torch.bfloat16)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a).to(torch.bfloat16) for a in
                     (frames, flows, masks)))
    assert_within_jax_bf16_spread(got.float().numpy(), want16, want32)
