"""Kernel K1 in bf16: the port's feature pyramid and K1's plain version
against the JAX package's fused Pallas kernel (interpret mode) on the
CPU.

On the JAX main path under bf16 the fused lookup keeps only a bf16
level 0 of fmap2, and every coarser tap is the f32 mean of level-0
correlations of bf16 operands. So the port's pyramid holds a bf16 level
0 and coarser levels pooled in f32 from it and kept in f32; rounding
those levels to bf16 (what the port did before) changes up to a quarter
of their taps. Inputs are bf16 values made with numpy, as RAFT's bf16
encoder hands them over.

Tolerance, with its reason: both sides compute the same products and sum
in other orders (pooled features against pooled correlations, XLA's dot
against torch's), so a tap can differ only where that f32 reassociation
tips it across a bf16 rounding boundary: per level at most 0.5% of the
taps may differ at all, none by more than one bf16 ulp of the level's
largest tap (top·2⁻⁷).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.models.raft import build_fmap_pyramid as jax_fmap_pyramid
from fgt_tpu.ops.corr_fused_pallas import lookup_corr_fused, pad_fmap_pyramid
from fgt_tpu_torch.ops import corr_fused as tcorr

torch.set_num_threads(1)


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 values, as f32."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _case(B, H, W, C, seed, spread=6.0):
    r = np.random.RandomState(seed)
    f1 = _bf16(r.randn(B, H, W, C))
    f2 = _bf16(r.randn(B, H, W, C))
    coords = (r.rand(B, H, W, 2) * [W, H]
              + r.randn(B, H, W, 2) * spread).astype(np.float32)
    return f1, f2, coords


def _jax_taps(f1, f2, coords, radius, levels) -> np.ndarray:
    """The JAX main path's bf16 fused lookup (``RAFT.refine`` with
    corr_dtype bfloat16)."""
    packed = pad_fmap_pyramid(jax_fmap_pyramid(jnp.asarray(f2), levels),
                              dtype="bfloat16")
    out = lookup_corr_fused(jnp.asarray(f1, jnp.bfloat16), packed,
                            jnp.asarray(coords), radius, interpret=True)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


def _port_taps(f1, pyramid, coords, radius) -> np.ndarray:
    out = tcorr.lookup_corr_fused(torch.from_numpy(f1).to(torch.bfloat16),
                                  pyramid, torch.from_numpy(coords), radius)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _level_stats(got, want, radius, levels) -> list:
    """Per level: (share of taps that differ, largest |diff| / one bf16
    ulp of the level's largest tap)."""
    kk = (2 * radius + 1) ** 2
    stats = []
    for lvl in range(levels):
        g = got[..., lvl * kk:(lvl + 1) * kk]
        w = want[..., lvl * kk:(lvl + 1) * kk]
        diff = np.abs(g - w)
        stats.append(((diff > 0).mean(),
                      diff.max() / (np.abs(w).max() * 2 ** -7)))
    return stats


CASES = [
    (1, 16, 24, 256, 4, 4, 0),    # main-path C, radius and levels
    (2, 16, 24, 256, 4, 4, 1),
    (1, 15, 21, 256, 4, 3, 2),    # odd sizes: floor pooling 15->7->3
]


@pytest.mark.parametrize("B,H,W,C,radius,levels,seed", CASES)
def test_k1_plain_bf16_matches_pallas_interpret(B, H, W, C, radius, levels,
                                                seed):
    f1, f2, coords = _case(B, H, W, C, seed)
    pyr = tcorr.build_fmap_pyramid(torch.from_numpy(f2), levels,
                                   dtype=torch.bfloat16)
    assert pyr[0].dtype == torch.bfloat16
    assert all(lv.dtype == torch.float32 for lv in pyr[1:])
    got = _port_taps(f1, pyr, coords, radius)
    want = _jax_taps(f1, f2, coords, radius, levels)
    assert got.shape == want.shape
    for lvl, (share, ulps) in enumerate(_level_stats(got, want, radius,
                                                     levels)):
        assert share <= 0.005, (lvl, share)
        assert ulps <= 1.0, (lvl, ulps)


def test_bf16_tolerance_rejects_bf16_coarse_levels():
    """The bound above has teeth: the pyramid the port stored before,
    with levels >= 1 rounded to bf16, breaks it on every coarse level."""
    f1, f2, coords = _case(*CASES[0][:4], CASES[0][-1])
    pyr = tcorr.build_fmap_pyramid(torch.from_numpy(f2), 4,
                                   dtype=torch.bfloat16)
    old = [pyr[0]] + [lv.to(torch.bfloat16) for lv in pyr[1:]]
    got = _port_taps(f1, old, coords, 4)
    want = _jax_taps(f1, f2, coords, 4, 4)
    shares = [s for s, _ in _level_stats(got, want, 4, 4)]
    assert all(s > 0.005 for s in shares[1:]), shares


def _old_f32_pyramid(fmap2, num_levels):
    """The f32 pyramid as the port built it before the bf16 repair."""
    x = fmap2.float().permute(0, 3, 1, 2)
    levels = [x]
    for _ in range(num_levels - 1):
        levels.append(torch.nn.functional.avg_pool2d(levels[-1], 2, 2))
    return [lv.permute(0, 2, 3, 1).contiguous() for lv in levels]


@pytest.mark.parametrize("H,W,levels", [(16, 24, 4), (15, 21, 3)])
def test_f32_pyramid_and_taps_unchanged(H, W, levels):
    """In f32 the repair changes nothing: every level and every tap is
    bit-identical to the pyramid built before it."""
    r = np.random.RandomState(H)
    f1, f2 = (torch.from_numpy(r.randn(2, H, W, 64).astype(np.float32))
              for _ in range(2))
    coords = torch.from_numpy(
        (r.rand(2, H, W, 2) * [W, H]).astype(np.float32))
    new = tcorr.build_fmap_pyramid(f2, levels)
    old = _old_f32_pyramid(f2, levels)
    for a, b in zip(new, old):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert torch.equal(tcorr.lookup_corr_plain(f1, new, coords, 4),
                       tcorr.lookup_corr_plain(f1, old, coords, 4))
