"""Kernel K3's module (``fgt_tpu_torch.ops.corr_lookup``) and RAFT's
all-pairs pyramid path against the JAX package, on the CPU, in f32:

* the lookup's plain version against ``lookup_corr_pyramid_pallas`` in
  interpret mode and the XLA ``lookup_corr_pyramid``, mirroring
  tests/test_corr_lookup_pallas.py (radius 2/3/4, odd level sizes, N
  not a multiple of any block, coords outside the levels);
* the lookup's bf16 taps (what the bf16 update block reads): the f32
  taps rounded once, on the CPU path of the wrapper too;
* ``build_corr_pyramid`` against the JAX one, f32 and bf16 storage;
* ``RAFT.refine(corr="pyramid")`` and ``RAFT.forward`` against
  ``RAFT.apply`` with JAX weights moved through ``jax_to_torch_state``
  (the RAFT table serves the pyramid path as it is).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.models.raft import (RAFT, RAFTConfig, build_corr_pyramid,
                                 lookup_corr_pyramid)
from fgt_tpu.ops.corr_lookup_pallas import lookup_corr_pyramid_pallas
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import raft as traft
from fgt_tpu_torch.ops import corr_lookup as tcl

torch.set_num_threads(1)


def _volumes(B, H, W, levels, seed):
    rng = np.random.RandomState(seed)
    n = B * H * W
    pyr = [rng.randn(n, max(H // 2 ** i, 1), max(W // 2 ** i, 1))
           .astype(np.float32) for i in range(levels)]
    # coords deliberately run outside the volume to hit zero padding
    coords = (rng.rand(B, H, W, 2) * [[W + 6, H + 6]] - 3).astype(np.float32)
    return pyr, coords


def _port(pyr, coords, radius):
    return tcl.lookup_corr_pyramid([torch.from_numpy(p) for p in pyr],
                                   torch.from_numpy(coords), radius).numpy()


@pytest.mark.parametrize("B,H,W,levels,radius,seed", [
    (2, 12, 20, 4, 4, 0),     # the main path's radius and level count
    (1, 5, 7, 2, 2, 1),       # N = 35: no multiple of a block
    (2, 9, 13, 3, 3, 2),      # odd sizes, the small RAFT's radius
    (1, 15, 11, 4, 4, 3),
])
def test_k3_plain_matches_pallas_and_xla_lookups(B, H, W, levels, radius,
                                                 seed):
    """Tolerance 2^-21 of the largest map value: each tap is two bilinear
    passes, which XLA's CPU dot contracts with FMA in a shape-dependent
    order (the two JAX lookups differ from each other the same way), so
    an entry may sit one f32 ulp away; the plain version rounds every
    product and sum on its own, as K3 does on the card."""
    pyr, coords = _volumes(B, H, W, levels, seed)
    got = _port(pyr, coords, radius)
    jp = [jnp.asarray(p) for p in pyr]
    ref = np.asarray(lookup_corr_pyramid(jp, jnp.asarray(coords), radius))
    pal = np.asarray(lookup_corr_pyramid_pallas(jp, jnp.asarray(coords),
                                                radius, interpret=True))
    k = 2 * radius + 1
    assert got.shape == ref.shape == (B, H, W, levels * k * k)
    assert got.dtype == np.float32
    tol = 2.0 ** -21 * max(np.abs(p).max() for p in pyr)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    np.testing.assert_allclose(got, pal, atol=tol, rtol=0)


@pytest.mark.parametrize("radius", [1, 3, 4])
def test_k3_plain_integer_coords_exact(radius):
    """At even integer coords both levels' fractions are 0, so every tap
    is one map value and no summation order can move a bit: equal to
    both JAX lookups, and the centre tap of level 0 is vol[n, y, x]."""
    rng = np.random.RandomState(4)
    B, H, W = 1, 8, 16
    n = B * H * W
    pyr = [rng.randn(n, H // 2 ** i, W // 2 ** i).astype(np.float32)
           for i in range(2)]
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"),
                    -1)[None]
    coords = (grid - grid % 2).astype(np.float32)
    got = _port(pyr, coords, radius)
    jp = [jnp.asarray(p) for p in pyr]
    np.testing.assert_array_equal(got, np.asarray(
        lookup_corr_pyramid(jp, jnp.asarray(coords), radius)))
    np.testing.assert_array_equal(got, np.asarray(lookup_corr_pyramid_pallas(
        jp, jnp.asarray(coords), radius, interpret=True)))
    k = 2 * radius + 1
    center = got.reshape(n, 2, k, k)[:, 0, radius, radius]
    c = coords.reshape(n, 2).astype(int)
    np.testing.assert_array_equal(center, pyr[0][np.arange(n), c[:, 1],
                                                  c[:, 0]])


@pytest.mark.parametrize("value", [1e4, -1e4, 1e9, -40.0])
def test_k3_plain_far_out_of_range_coords_zero(value):
    """Taps fully outside every level are exactly zero."""
    pyr, _ = _volumes(1, 12, 20, 4, 5)
    coords = np.full((1, 12, 20, 2), value, np.float32)
    assert np.abs(_port(pyr, coords, 4)).max() == 0.0


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [3, 4])
def test_k3_plain_bf16_taps_are_f32_taps_rounded_once(storage, radius):
    """``out_dtype=bf16`` rounds each f32 tap once to nearest-even, as
    the JAX update block's bf16 conv rounds its f32 input: equal to
    ``.to(torch.bfloat16)`` of the f32 taps, bit for bit, through the
    wrapper's CPU path as through the plain version."""
    pyr, coords = _volumes(2, 12, 20, 4, 7)
    vols = [torch.from_numpy(p).to(storage) for p in pyr]
    c = torch.from_numpy(coords)
    f32 = tcl.lookup_corr_pyramid_plain(vols, c, radius)
    for fn in (tcl.lookup_corr_pyramid_plain, tcl.lookup_corr_pyramid):
        got = fn(vols, c, radius, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, f32.to(torch.bfloat16))
    assert not torch.equal(f32, f32.to(torch.bfloat16).float())


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_build_corr_pyramid_matches_jax(storage):
    """Odd sizes (9x13 -> 4x6 -> 2x3 -> 1x1), chunked in 2 pairs of 3:
    bit-exact in f32 and in bf16 storage (both pool the f32 product)."""
    rng = np.random.RandomState(6)
    f1 = rng.randn(3, 9, 13, 64).astype(np.float32)
    f2 = rng.randn(3, 9, 13, 64).astype(np.float32)
    jdt = None if storage == "float32" else jnp.bfloat16
    want = build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4, dtype=jdt,
                              build_chunk=2)
    got = tcl.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4,
                                 dtype=getattr(torch, storage), build_chunk=2)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(w.astype(jnp.float32)))


@pytest.fixture(scope="module")
def raft_pair():
    rng = np.random.RandomState(3)
    video = rng.randint(0, 255, (3, 64, 72, 3)).astype(np.float32)
    model = RAFT(RAFTConfig(iters=2))
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, iters=1))(
        jax.random.PRNGKey(1), jnp.asarray(video[:1]), jnp.asarray(video[1:2]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = traft.RAFT().eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.raft_mapping()))
    return model, variables, port, video


def test_raft_refine_pyramid_matches_jax(raft_pair):
    """2 GRU iterations on the pyramid path against the JAX refine (XLA
    pyramid lookup); tolerance 1e-3 px at 1/8 and 5e-3 px upsampled (f32
    conv reassociation across the update block)."""
    model, variables, port, video = raft_pair
    fmap, net, inp = model.apply(variables, jnp.asarray(video),
                                 method="encode")
    lo, up = model.apply(variables, fmap[:2], fmap[1:], net[:2], inp[:2],
                         iters=2, method="refine")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tcl.lookup_corr_pyramid.launches = 0
    with torch.no_grad():
        lo_t, up_t = port.refine(t(fmap[:2]), t(fmap[1:]), t(net[:2]),
                                 t(inp[:2]), iters=2, corr="pyramid")
    assert tcl.lookup_corr_pyramid.launches == 0       # CPU: plain version
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo), atol=1e-3)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up), atol=5e-3)


def test_raft_forward_matches_jax_call(raft_pair):
    """``RAFT.forward`` (fnet on both images, cnet on the first, pyramid
    refine) against ``RAFT.apply(a, b)`` of the JAX package; same
    tolerances."""
    model, variables, port, video = raft_pair
    a, b = video[:2], video[1:]
    lo, up = model.apply(variables, jnp.asarray(a), jnp.asarray(b), iters=2,
                         test_mode=True)
    with torch.no_grad():
        lo_t, up_t = port(torch.from_numpy(a), torch.from_numpy(b), 2)
    assert up_t.shape == (2, 64, 72, 2)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo), atol=1e-3)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up), atol=5e-3)


def test_raft_pyramid_and_fused_paths_agree(raft_pair):
    """The port's correlation paths on the same features: pooling the
    correlation equals correlating pooled features up to f32
    reassociation (2e-3 px upsampled); in an f32 model the alternate
    path (K1 in f32) is the fused path, bit for bit; an unknown path
    raises."""
    _, _, port, video = raft_pair
    x = torch.from_numpy(video)
    with torch.no_grad():
        fmap, net, inp = port.encode(x)
        args = (fmap[:2], fmap[1:], net[:2], inp[:2], 2)
        _, up_p = port.refine(*args, corr="pyramid")
        _, up_f = port.refine(*args, corr="fused")
        _, up_a = port.refine(*args, corr="alternate")
    np.testing.assert_allclose(up_p.numpy(), up_f.numpy(), atol=2e-3)
    np.testing.assert_array_equal(up_a.numpy(), up_f.numpy())
    with pytest.raises(ValueError):
        port.refine(*args, corr="xla")
