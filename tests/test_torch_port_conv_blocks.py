"""The port's conv block library (``fgt_tpu_torch/ops/conv_blocks.py``)
against ``fgt_tpu.ops.conv_blocks``, on the CPU, in f32.

Every block class (vanilla, gated, partial) at rank 2 and 3, with and
without bias, as a conv and as a deconv, under each norm: none, BN in
eval mode (running statistics) and in train mode (batch statistics; the
updated running mean and var are compared too), IN, and SN without and
with ``sn_update`` (the updated u and v are compared too). The JAX
variables (random norm scales, biases and running statistics, so that an
identity layer hides nothing) move to the port through the weight
tables' own ``convert.weights._block``; SN's u and v after two power
iterations. The partial blocks' input mask
holds a hole wider than the kernel, so some windows see no valid pixel:
their output is 0 and the new mask equals JAX's. Then the geometry
(stride, dilation, groups, ``padding=-1``) under SN, whose ``v`` the
tables permute, and ``upsample_nearest`` / ``replication_pad`` on 4-D and
5-D tensors. Tolerance 2e-5 (abs and rel) throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.ops import conv_blocks as jcb
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.ops import conv_blocks as tcb

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)
CIN, COUT = 4, 6
NORM_MODES = ["none", "BN", "BN_train", "IN", "SN", "SN_update"]


def _nc(a):
    """Channel-last numpy -> channel-first torch."""
    return torch.from_numpy(np.moveaxis(np.asarray(a), -1, 1).copy())


def _cl(t):
    """Channel-first torch -> channel-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _randomize_norms(variables, rng):
    """Random BN / IN scales and biases, BN running mean and var > 0."""
    out = jax.tree_util.tree_map(np.asarray, variables)

    def walk(node, coll):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, coll)
            elif coll == "batch_stats":
                node[k] = (rng.rand(*v.shape) + 0.5 if k == "var"
                           else rng.randn(*v.shape) * 0.3).astype(np.float32)
            elif k in ("scale", "bias") and v.ndim == 1:
                node[k] = (rng.randn(*v.shape) * 0.3
                           + (k == "scale")).astype(np.float32)
    for coll, tree in out.items():
        walk(tree, coll)
    return out


def _warm_sn(jm, variables, args):
    """u, v after two of JAX's power iterations: the init's random pair
    can make sigma = u·W·v nearly cancel, and a result divided by it
    measures that cancellation, not the port."""
    if "spectral" not in variables:
        return variables
    for _ in range(2):
        _, new = jm.apply(variables, *args, sn_update=True,
                          mutable=["spectral"])
        variables = dict(variables, spectral=jax.tree_util.tree_map(
            np.asarray, new["spectral"]))
    return variables


def _port_state(variables, conv_type, norm, kind, bias, deconv):
    mapping = weights._block((), "b", conv_type, norm, kind, bias, deconv)
    state = weights.jax_to_torch_state(variables, mapping)
    return {k[2:]: v for k, v in state.items()}


def _inputs(rank, rng, size=8):
    spatial = ((3,) if rank == 3 else ()) + (size, size)
    x = rng.randn(2, *spatial, CIN).astype(np.float32)
    mask = np.ones((2, *spatial, 1), np.float32)
    mask[..., 1:6, 1:6, :] = 0.0          # windows of 3 inside see no pixel
    mask[1, ..., 0, :, :] = 0.0
    return x, mask


@pytest.mark.parametrize("deconv", [False, True])
@pytest.mark.parametrize("norm_mode", NORM_MODES)
@pytest.mark.parametrize("rank", [2, 3])
@pytest.mark.parametrize("conv_type", ["vanilla", "gated", "partial"])
def test_block_matches_jax(conv_type, rank, norm_mode, deconv):
    norm = norm_mode.split("_")[0] if norm_mode != "none" else None
    train, sn_update = norm_mode == "BN_train", norm_mode == "SN_update"
    bias = (rank + len(norm_mode) + deconv) % 2 == 0   # both, across cases
    kind = "conv2d" if rank == 2 else "conv3d"
    rng = np.random.RandomState(rank * 10 + NORM_MODES.index(norm_mode))
    x, mask = _inputs(rank, rng)
    jcls = jcb.conv_classes[conv_type][int(deconv)]
    jm = jcls(COUT, (3,) * rank, padding=1, use_bias=bias, norm=norm)
    partial = conv_type == "partial"
    args = ((jnp.asarray(x), jnp.asarray(mask)),) if partial \
        else (jnp.asarray(x),)
    variables = _warm_sn(jm, _randomize_norms(
        jm.init(jax.random.PRNGKey(rank), *args), rng), args)
    mutable = (["batch_stats"] if train else
               ["spectral"] if sn_update else False)
    out = jm.apply(variables, *args, train=train, sn_update=sn_update,
                   mutable=mutable)
    want, new_vars = out if mutable else (out, {})

    port = tcb.conv_classes[conv_type][int(deconv)](
        CIN, COUT, 3, 1, 1, bias=bias, norm=norm, rank=rank)
    weights.load_state(port, _port_state(variables, conv_type, norm, kind,
                                         bias, deconv))
    targs = ((_nc(x), _nc(mask)),) if partial else (_nc(x),)
    got = port(*targs, train=train, sn_update=sn_update)
    if partial:
        (got, got_mask), (want, want_mask) = got, want
        np.testing.assert_array_equal(_cl(got_mask), np.asarray(want_mask))
        holes = np.asarray(want_mask) == 0
        assert holes.any()
        if norm not in ("BN", "IN"):     # a norm shifts the zeros
            assert (_cl(got)[np.broadcast_to(holes, want.shape)] == 0).all()
    np.testing.assert_allclose(_cl(got), np.asarray(want), **TOL)

    if mutable:   # the moved BN statistics or SN vectors, back in flax
        back = weights.torch_to_jax_leaves(
            {f"b.{k}": v for k, v in port.state_dict().items()},
            weights._block((), "b", conv_type, norm, kind, bias, deconv))
        flat = {tuple(p.key for p in path): v for path, v in
                jax.tree_util.tree_flatten_with_path(new_vars)[0]}
        # the partial blocks carry no spectral state
        assert bool(flat) == (train or not partial)
        for key, leaf in flat.items():
            np.testing.assert_allclose(back[key], np.asarray(leaf), **TOL)
            assert not np.array_equal(np.asarray(leaf), _get(variables, key))


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


@pytest.mark.parametrize("conv_type", ["vanilla", "gated"])
@pytest.mark.parametrize("rank,kw", [
    (2, dict(strides=2, padding=2, dilation=2, groups=2)),
    (2, dict(strides=1, padding=-1, dilation=3, groups=1)),
    (3, dict(strides=(1, 2, 2), padding=(1, 0, 1), dilation=1, groups=2)),
    (3, dict(strides=1, padding=-1, dilation=(1, 2, 2), groups=1)),
])
def test_sn_geometry_matches_jax(conv_type, rank, kw):
    """SN with sn_update on strided / dilated / grouped / "same"-padded
    convs: the output, and u and v after the power iteration, whose v
    the tables permute between k..·I and I·k.."""
    rng = np.random.RandomState(rank)
    x = rng.randn(2, *((3,) * (rank - 2)), 9, 9, CIN).astype(np.float32)
    k = (3,) * rank
    jm = jcb.conv_classes[conv_type][0](COUT, k, norm="SN", **kw)
    variables = _warm_sn(jm, jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))),
        (jnp.asarray(x),))
    want, new = jm.apply(variables, jnp.asarray(x), sn_update=True,
                         mutable=["spectral"])
    kind = "conv2d" if rank == 2 else "conv3d"
    port = tcb.conv_classes[conv_type][0](
        CIN, COUT, 3, kw["strides"], kw["padding"], kw["dilation"],
        kw["groups"], norm="SN", rank=rank)
    mapping = weights._block((), "b", conv_type, "SN", kind)
    weights.load_state(port, _port_state(variables, conv_type, "SN", kind,
                                         True, False))
    got = port(_nc(x), sn_update=True)
    np.testing.assert_allclose(_cl(got), np.asarray(want), **TOL)
    back = weights.torch_to_jax_leaves(
        {f"b.{k}": v for k, v in port.state_dict().items()}, mapping)
    for name in ("conv",) if conv_type == "vanilla" else ("feature",
                                                          "gating"):
        for vec in ("u", "v"):
            np.testing.assert_allclose(
                back[("spectral", name, vec)],
                np.asarray(new["spectral"][name][vec]), **TOL)


@pytest.mark.parametrize("shape", [(2, 5, 6, 3), (2, 4, 5, 6, 3)])
@pytest.mark.parametrize("factor", [1, 2, 3])
def test_upsample_and_pad_match_jax(shape, factor):
    """Exact: a 5-D tensor keeps its temporal size (the deconvs' former
    ``F.interpolate(x, scale_factor=2)`` doubled it)."""
    x = np.random.RandomState(factor).randn(*shape).astype(np.float32)
    got = _cl(tcb.upsample_nearest(_nc(x), factor))
    want = np.asarray(jcb.upsample_nearest(jnp.asarray(x), factor))
    assert got.shape == want.shape and got.shape[1] == shape[1] * (
        factor if len(shape) == 4 else 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _cl(tcb.replication_pad(_nc(x), factor)),
        np.asarray(jcb.replication_pad(jnp.asarray(x), factor)))
