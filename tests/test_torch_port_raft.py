"""RAFT in the PyTorch port vs the JAX package, on the CPU, in f32.

* kernel K1's plain version (``fgt_tpu_torch.ops.corr_fused``) against
  the fused Pallas kernel in interpret mode and against the all-pairs
  pyramid lookup, mirroring tests/test_corr_fused.py;
* RAFT ``encode`` / ``refine`` (2 iterations) with the same weights,
  moved through ``convert.weights.jax_to_torch_state``;
* the s1 flow resize (antialiased bilinear shrink) against
  ``jax.image.resize``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.models.raft import (RAFT, RAFTConfig, build_corr_pyramid,
                                 build_fmap_pyramid, lookup_corr_pyramid)
from fgt_tpu.ops.corr_fused_pallas import lookup_corr_fused, pad_fmap_pyramid
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import raft as traft
from fgt_tpu_torch.ops import corr_fused as tcorr
from fgt_tpu_torch.pipeline.video_inpainting import resize_flows

torch.set_num_threads(1)


def _case(B, H, W, C, seed=0, spread=6.0):
    r = np.random.RandomState(seed)
    f1 = r.randn(B, H, W, C).astype(np.float32)
    f2 = r.randn(B, H, W, C).astype(np.float32)
    coords = (r.rand(B, H, W, 2) * [W, H]
              + r.randn(B, H, W, 2) * spread).astype(np.float32)
    return f1, f2, coords


def _port_lookup(f1, f2, coords, radius, levels):
    pyr = tcorr.build_fmap_pyramid(torch.from_numpy(f2), levels)
    return tcorr.lookup_corr_fused(torch.from_numpy(f1), pyr,
                                   torch.from_numpy(coords), radius).numpy()


@pytest.mark.parametrize("B,H,W,C,radius,levels,seed", [
    (2, 16, 24, 64, 4, 4, 0),    # main-path radius/levels
    (2, 16, 24, 64, 3, 4, 1),
    (1, 16, 24, 64, 4, 1, 2),
    (2, 15, 9, 32, 2, 2, 3),     # odd sizes: floor pooling 15->7, 9->4
])
def test_k1_plain_matches_pallas_and_pyramid(B, H, W, C, radius, levels,
                                             seed):
    """Tolerance 2e-5 of the tap scale: f32 reassociation only (pooling
    features vs pooling correlations, as tests/test_corr_fused.py)."""
    f1, f2, coords = _case(B, H, W, C, seed)
    got = _port_lookup(f1, f2, coords, radius, levels)
    ref = np.asarray(lookup_corr_pyramid(
        build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels),
        jnp.asarray(coords), radius))
    fused = np.asarray(lookup_corr_fused(
        jnp.asarray(f1), pad_fmap_pyramid(build_fmap_pyramid(
            jnp.asarray(f2), levels)), jnp.asarray(coords), radius,
        interpret=True))
    assert got.shape == ref.shape == (B, H, W, levels * (2 * radius + 1) ** 2)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)
    np.testing.assert_allclose(got, fused, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("value", [1e4, -1e4, 1e9])
def test_k1_plain_far_out_of_range_coords_zero(value):
    """Taps fully outside every level are exactly zero (grid_sample zero
    padding)."""
    f1, f2, _ = _case(1, 16, 24, 64)
    coords = np.full((1, 16, 24, 2), value, np.float32)
    assert np.abs(_port_lookup(f1, f2, coords, 4, 4)).max() == 0.0


def test_k1_plain_right_edge_boundary():
    """Patches straddling the W boundary: masking must match the
    pyramid lookup (tolerance 2e-5 of the tap scale)."""
    B, H, W, C = 1, 8, 24, 64
    f1, f2, _ = _case(B, H, W, C, seed=2)
    coords = np.stack([np.full((B, H, W), W - 1.25),
                       np.full((B, H, W), 3.5)], -1).astype(np.float32)
    ref = np.asarray(lookup_corr_pyramid(
        build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4),
        jnp.asarray(coords), 4))
    got = _port_lookup(f1, f2, coords, 4, 4)
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max())


def _perturb_batch_norms(variables, rng):
    """Random BN scale/bias/mean/var so the frozen batch norm is really
    exercised (flax init leaves them at identity)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node)
        if "BatchNorm_0" not in path:
            return a
        if path[-1] == "var":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        if path[-1] == "scale":
            return (0.5 + rng.rand(*a.shape)).astype(np.float32)
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)
    return walk(jax.tree_util.tree_map(np.asarray, variables), ())


@pytest.fixture(scope="module")
def raft_pair():
    rng = np.random.RandomState(3)
    video = rng.randint(0, 255, (3, 64, 64, 3)).astype(np.float32)
    model = RAFT(RAFTConfig(iters=2))
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, iters=1))(
        jax.random.PRNGKey(0), jnp.asarray(video[:1]), jnp.asarray(video[1:2]))
    variables = _perturb_batch_norms(variables, rng)
    port = traft.RAFT().eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.raft_mapping()))
    return model, variables, port, video


def test_raft_encode_matches_jax(raft_pair):
    """f32 features; tolerance 1e-4 absolute: conv reassociation across
    ten conv layers and instance-norm variance formulas."""
    model, variables, port, video = raft_pair
    want = model.apply(variables, jnp.asarray(video), method="encode")
    with torch.no_grad():
        got = port.encode(torch.from_numpy(video))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_raft_refine_matches_jax(raft_pair):
    """2 GRU iterations, K1's plain version vs the XLA pyramid lookup;
    tolerance 1e-3 px on the 1/8 flow and 5e-3 px on the upsampled flow
    (f32 reassociation of the correlation, as in
    tests/test_corr_fused.py::test_raft_refine_fused_matches_default)."""
    model, variables, port, video = raft_pair
    fmap, net, inp = model.apply(variables, jnp.asarray(video),
                                 method="encode")
    lo, up = model.apply(variables, fmap[:2], fmap[1:], net[:2], inp[:2],
                         iters=2, method="refine")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    with torch.no_grad():
        lo_t, up_t = port.refine(t(fmap[:2]), t(fmap[1:]), t(net[:2]),
                                 t(inp[:2]), iters=2)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo), atol=1e-3)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up), atol=5e-3)


def test_flow_resize_antialias_matches_jax():
    """s1 shrinks flows from flow to image resolution with
    jax.image.resize(..., "bilinear"), which antialiases; the port's
    F.interpolate(antialias=True) must agree (1e-5 absolute, f32) and
    differ clearly from the non-antialiased filter."""
    rng = np.random.RandomState(0)
    flow = (rng.randn(2, 48, 80, 2) * 5).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(flow), (2, 24, 40, 2),
                                       "bilinear")) * np.float32([0.5, 0.5])
    got = resize_flows(torch.from_numpy(flow), 24, 40).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(flow).permute(0, 3, 1, 2), size=(24, 40),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy() * 0.5
    assert np.abs(plain - want).max() > 0.1


def test_frame_upscale_matches_jax():
    """The 2x frame upscale before encoding: jax.image.resize bilinear
    (no antialias when enlarging) == F.interpolate bilinear."""
    rng = np.random.RandomState(1)
    fr = rng.randint(0, 255, (2, 12, 20, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(fr), (2, 24, 40, 3),
                                       "bilinear"))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(fr).permute(0, 3, 1, 2), size=(24, 40),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
