"""The port's legacy block library (``fgt_tpu_torch/ops/legacy_blocks.py``
and ``recon_layers.py``) against ``fgt_tpu.ops.legacy_blocks`` and
``fgt_tpu.ops.recon_layers``, on the CPU, in f32: every class on seeded
numpy inputs, the JAX variables carried over leaf by leaf (the port keeps
the JAX submodule names), the gated 2-D convs also with spectral norm and
``sn_update`` (output, u and v), the deconvs' upsampling keeping a video's
temporal size; ``make_layer``, ``mean_channels`` / ``stdv_channels``, and
``trunc_normal_init``'s bounds and moments. Tolerance 2e-5 (abs and
rel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.ops import legacy_blocks as jlb
from fgt_tpu.ops import recon_layers as jrl
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.ops import legacy_blocks as tlb
from fgt_tpu_torch.ops import recon_layers as trl

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)


def _nc(a):
    return torch.from_numpy(np.moveaxis(np.asarray(a), -1, 1).copy())


def _cl(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _mapping(variables, port):
    """Every leaf of the JAX tree onto the port's key of the same path
    (kernel -> weight, or weight_orig under SN; scale -> weight; the
    spectral u / v -> weight_u / weight_v)."""
    own = port.state_dict()
    m = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        path = tuple(p.key for p in path)
        stem = ".".join(path[1:-1])
        name = path[-1]
        if path[0] == "spectral":
            m[path] = (f"{stem}.weight_{name}", "sn_v" if name == "v"
                       else "raw")
        elif name == "kernel":
            key = f"{stem}.weight" if f"{stem}.weight" in own \
                else f"{stem}.weight_orig"
            m[path] = (key, "conv2d" if leaf.ndim == 4 else "conv3d")
        else:
            m[path] = (f"{stem}.bias", "raw")
    return m


def _carry(jm, port, *args, **kw):
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), *args, **kw))
    mapping = _mapping(variables, port)
    weights.load_state(port, weights.jax_to_torch_state(variables, mapping))
    return variables, mapping


@pytest.mark.parametrize("name", ["aspp", "gated2d", "gated2d_sn",
                                  "gated2d_noact", "gated_deconv2d",
                                  "gated_deconv2d_sn", "gated3d",
                                  "gated_deconv3d", "resblock_new", "cca"])
def test_legacy_block_matches_jax(name):
    rng = np.random.RandomState(len(name))
    x2 = rng.randn(2, 10, 12, 8).astype(np.float32)
    x3 = rng.randn(2, 3, 10, 12, 8).astype(np.float32)
    sn = name.endswith("_sn")
    if name == "aspp":
        jm, port, x = jlb.ASPP(8), tlb.ASPP(8, 8), x2
    elif name.startswith("gated2d"):
        kw = dict(padding=2, dilation=2, spectral_norm=sn)
        act = name != "gated2d_noact"
        jm = jlb.GatedConv2dWithActivation(6, 3, use_activation=act, **kw)
        port = tlb.GatedConv2dWithActivation(8, 6, 3, use_activation=act,
                                             **kw)
        x = x2
    elif name.startswith("gated_deconv2d"):
        jm = jlb.GatedDeConv2dWithActivation(2, 6, 3, padding=1,
                                             spectral_norm=sn)
        port = tlb.GatedDeConv2dWithActivation(2, 8, 6, 3, padding=1,
                                               spectral_norm=sn)
        x = x2
    elif name == "gated3d":
        jm, port, x = (jlb.GatedConv3d(6, (1, 3, 3), padding=(0, 1, 1)),
                       tlb.GatedConv3d(8, 6, (1, 3, 3), padding=(0, 1, 1)),
                       x3)
    elif name == "gated_deconv3d":
        jm, port, x = (jlb.GatedDeconv3d(2, 6, 3, padding=1),
                       tlb.GatedDeconv3d(2, 8, 6, 3, padding=1), x3)
    elif name == "resblock_new":
        jm, port, x = jrl.ResBlockNoBNNew(8), trl.ResBlockNoBNNew(8), x3
    else:
        jm, port, x = jrl.CCALayer(8), trl.CCALayer(8), x2
    variables, mapping = _carry(jm, port, jnp.asarray(x))
    if sn:
        want, new = jm.apply(variables, jnp.asarray(x), sn_update=True,
                             mutable=["spectral"])
        got = port(_nc(x), sn_update=True)
        back = weights.torch_to_jax_leaves(port.state_dict(), mapping)
        for path, leaf in jax.tree_util.tree_flatten_with_path(new)[0]:
            np.testing.assert_allclose(back[tuple(p.key for p in path)],
                                       np.asarray(leaf), **TOL)
    else:
        want, got = jm.apply(variables, jnp.asarray(x)), port(_nc(x))
    assert _cl(got).shape == np.asarray(want).shape
    if "deconv3d" in name:       # the temporal size is kept
        assert want.shape[1] == x.shape[1]
    np.testing.assert_allclose(_cl(got), np.asarray(want), **TOL)


def test_make_layer_and_channel_stats_match_jax():
    x = np.random.RandomState(0).randn(2, 7, 9, 5).astype(np.float32)
    np.testing.assert_allclose(_cl(trl.mean_channels(_nc(x))),
                               np.asarray(jrl.mean_channels(jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(_cl(trl.stdv_channels(_nc(x))),
                               np.asarray(jrl.stdv_channels(jnp.asarray(x))),
                               **TOL)
    stack = trl.make_layer(lambda i: trl.ResidualBlockNoBN(5), 3)
    assert isinstance(stack, torch.nn.Sequential) and len(stack) == 3
    blocks = [jrl.ResidualBlockNoBN(5) for _ in range(3)]
    want, xin = jnp.asarray(x), jnp.asarray(x)
    for b, tb in zip(blocks, stack):
        v = jax.tree_util.tree_map(np.asarray,
                                   b.init(jax.random.PRNGKey(1), xin))
        weights.load_state(tb, weights.jax_to_torch_state(v, _mapping(v, tb)))
        want = b.apply(v, want)
    np.testing.assert_allclose(_cl(stack(_nc(x))), np.asarray(want), **TOL)


def test_trunc_normal_init_matches_jax_distribution():
    """Samples lie in [a, b]; mean and std agree with JAX's sampler's
    within 4 standard errors (200k samples each)."""
    std, mean, a, b = 0.7, 0.2, -0.5, 1.5
    got = tlb.trunc_normal_init(std, mean, a, b)(
        (200_000,), torch.Generator().manual_seed(0)).numpy()
    want = np.asarray(jlb.trunc_normal_init(std, mean, a, b)(
        jax.random.PRNGKey(0), (200_000,)))
    for s in (got, want):
        assert s.min() >= a and s.max() <= b
    se = want.std() / np.sqrt(want.size)
    assert abs(got.mean() - want.mean()) < 4 * np.sqrt(2) * se
    assert abs(got.std() / want.std() - 1) < 0.01
