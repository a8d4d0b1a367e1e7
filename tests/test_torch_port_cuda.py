"""The port's CUDA kernels (K1-K7) against their plain versions. These need a
GPU and nvcc: marked ``cuda``; they skip on machines without a card and
run there with

    python -m pytest tests/test_torch_port_cuda.py -m cuda
"""

import math

import numpy as np
import pytest
import torch

from fgt_tpu_torch.ops import corr_fused as cf
from fgt_tpu_torch.ops import corr_lookup as cl
from fgt_tpu_torch.ops import diffusion as k7
from fgt_tpu_torch.ops import flash_attention as fa
from fgt_tpu_torch.ops import poisson as k6
from fgt_tpu_torch.pipeline import poisson as tpoisson
from torch_port_diffusion_cases import case as k7_case
from torch_port_diffusion_cases import counted
from torch_port_poisson_cases import case, splu_clip, worst_filled_gap

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("dtype,c,radius,levels", [
    (torch.float32, 64, 4, 4), (torch.bfloat16, 256, 4, 4),
    (torch.float32, 32, 2, 2), (torch.float32, 128, 3, 4),
    (torch.bfloat16, 128, 3, 4)])
def test_k1_kernel_matches_plain(dev, dtype, c, radius, levels):
    g = torch.Generator(device=dev).manual_seed(0)
    f1 = torch.randn(2, 15, 21, c, device=dev, generator=g).to(dtype)
    f2 = torch.randn(2, 15, 21, c, device=dev, generator=g)
    pyr = cf.build_fmap_pyramid(f2, levels, dtype=dtype)
    coords = torch.rand(2, 15, 21, 2, device=dev, generator=g) * 24 - 2
    coords[0, 0] = 1e4
    before = cf.lookup_corr_fused.launches
    got = cf.lookup_corr_fused(f1, pyr, coords, radius).float()
    want = cf.lookup_corr_plain(f1, pyr, coords, radius).float()
    assert cf.lookup_corr_fused.launches == before + 1
    top = want.abs().max().item()
    tol = 1e-4 * max(1.0, top) if dtype == torch.float32 else top * 2 ** -7
    assert (got - want).abs().max().item() <= tol
    assert got[0, 0].abs().max().item() == 0.0


def smooth_coords(b, h, w, gen, nodes=(3, 4), amp=8.0):
    """The pixel grid plus a smooth random flow: a low-resolution field
    of ``amp`` px, bilinearly upsampled. [b, h, w, 2] f32 (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    grid = torch.stack([xs, ys], -1).float()[None].repeat(b, 1, 1, 1)
    field = amp * torch.randn(b, 2, *nodes, generator=gen)
    flow = torch.nn.functional.interpolate(field, size=(h, w),
                                           mode="bilinear",
                                           align_corners=True)
    return grid + flow.permute(0, 2, 3, 1)


@pytest.mark.parametrize("kind,c", [("smooth", 256), ("noisy", 256),
                                    ("smooth", 64), ("noisy", 128)])
def test_k1_bf16_tile_routes_match_plain(dev, kind, c):
    """K1's bf16 body (bf16 level 0, f32 coarser levels) against its plain
    version at odd level sizes (45x75 -> 22x37 -> 11x18 -> 5x9, the
    image's right and bottom tiles partial), with far coords in some
    tiles. Tolerance one bf16 ulp of the largest tap: the kernel's f32
    sums (tensor-core products, hi + lo for the f32 levels) and the plain
    version's run in other orders, so a tap may round to the neighbouring
    bf16 value. Far coords give exact zeros. The kernel's route counts
    equal tile_routes': smooth flow keeps every tile on the box route,
    per-pixel noise sends most of level 0's tiles to the general
    route."""
    gen = torch.Generator().manual_seed(c + len(kind))
    b, h, w, r, levels = 2, 45, 75, 4, 4
    f1 = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16)
    f2 = torch.randn(b, h, w, c, generator=gen)
    if kind == "smooth":
        coords = smooth_coords(b, h, w, gen)
    else:
        coords = smooth_coords(b, h, w, gen, amp=0.0) + \
            8 * torch.randn(b, h, w, 2, generator=gen)
    coords[0, :3] = 1e4                          # far out of range
    coords[1, 40:, 64:] = -3e3                   # a corner tile far off
    f1, f2, coords = f1.to(dev), f2.to(dev), coords.to(dev)
    pyr = cf.build_fmap_pyramid(f2, levels, dtype=torch.bfloat16)
    cf.reset_route_tiles()
    before = cf.lookup_corr_fused.launches
    got = cf.lookup_corr_fused(f1, pyr, coords, r)
    assert cf.lookup_corr_fused.launches == before + 1
    routes = cf.route_tiles()
    want = cf.lookup_corr_plain(f1, pyr, coords, r)
    assert got.dtype == torch.bfloat16
    top = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= top * 2 ** -7
    assert got[0, :3].abs().max().item() == 0.0
    assert got[1, 40:, 64:].abs().max().item() == 0.0
    assert routes == cf.tile_routes(coords, [lv.shape[1:3] for lv in pyr], r)
    if kind == "smooth":
        assert routes["general"] == 0 and routes["box"] > 0
    else:
        assert routes["general"] > 0 and routes["box"] > 0


@pytest.mark.parametrize("kind", ["smooth", "noisy"])
def test_k1_bf16_raft_small_shape_matches_plain(dev, kind):
    """RAFT small's K1 shape in bf16: C = 128, radius 3, 4 levels of a
    60x108 feature map (60x108, 30x54, 15x27, 7x13), 2 pairs; against the
    plain version to one bf16 ulp of the largest tap, with the kernel's
    route counts equal to tile_routes' (smooth flow: all box route)."""
    gen = torch.Generator().manual_seed(11 + len(kind))
    b, h, w, c, r = 2, 60, 108, 128, 3
    f1 = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16)
    f2 = torch.randn(b, h, w, c, generator=gen)
    coords = smooth_coords(b, h, w, gen, amp=8.0 if kind == "smooth" else 0.0)
    if kind == "noisy":
        coords = coords + 8 * torch.randn(b, h, w, 2, generator=gen)
    coords[0, :2] = 1e4
    f1, f2, coords = f1.to(dev), f2.to(dev), coords.to(dev)
    pyr = cf.build_fmap_pyramid(f2, 4, dtype=torch.bfloat16)
    cf.reset_route_tiles()
    got = cf.lookup_corr_fused(f1, pyr, coords, r)
    routes = cf.route_tiles()
    want = cf.lookup_corr_plain(f1, pyr, coords, r)
    assert got.shape == (b, h, w, 4 * 49) and got.dtype == torch.bfloat16
    top = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= top * 2 ** -7
    assert got[0, :2].abs().max().item() == 0.0
    assert routes == cf.tile_routes(coords, [lv.shape[1:3] for lv in pyr], r)
    assert (routes["general"] == 0) == (kind == "smooth")


def test_k1_rejects_bf16_coarse_levels(dev):
    """In bf16 the kernel takes f32 levels >= 1 only (the repaired
    pyramid); a pyramid rounded to bf16 throughout is refused."""
    f = torch.randn(1, 8, 8, 64, device=dev)
    pyr = cf.build_fmap_pyramid(f, 2, dtype=torch.bfloat16)
    coords = torch.zeros(1, 8, 8, 2, device=dev)
    with pytest.raises(ValueError):
        cf.lookup_corr_fused(f.to(torch.bfloat16),
                             [lv.to(torch.bfloat16) for lv in pyr], coords, 1)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype,radius,levels,h,w", [
    (torch.float32, 4, 4, 15, 21), (torch.bfloat16, 4, 4, 15, 21),
    (torch.float32, 3, 4, 9, 13), (torch.bfloat16, 3, 3, 12, 20),
    (torch.float32, 3, 2, 5, 7), (torch.bfloat16, 4, 4, 60, 108),
    (torch.float32, 3, 4, 60, 108), (torch.bfloat16, 3, 4, 60, 108)])
def test_k3_kernel_matches_plain(dev, dtype, radius, levels, h, w,
                                 out_dtype):
    """K3 against its plain version: the same products and sums, each
    rounded on its own, so the taps are equal (f32 and bf16 storage; bf16
    taps are the f32 taps rounded once); pixels far outside every level
    give exact zeros. At 60x108 each persistent warp walks several pixels
    through its two-slot ring."""
    g = torch.Generator(device=dev).manual_seed(4)
    n = 2 * h * w
    pyr = [torch.randn(n, hl, wl, device=dev, generator=g).to(dtype)
           for hl, wl in cl.pyramid_sizes(h, w, levels)]
    coords = torch.rand(2, h, w, 2, device=dev, generator=g) * (w + 6) - 3
    coords[0, 0] = 1e4
    coords[0, 1] = -3e3
    coords[1, 1, :, 0] = w - 1
    coords[1, 2, :, 0] = -0.5
    before = cl.lookup_corr_pyramid.launches
    got = cl.lookup_corr_pyramid(pyr, coords, radius, out_dtype=out_dtype)
    assert cl.lookup_corr_pyramid.launches == before + 1
    want = cl.lookup_corr_pyramid_plain(pyr, coords, radius, out_dtype)
    assert got.dtype == out_dtype
    assert torch.equal(got, want)
    assert got[0, :2].abs().max().item() == 0.0
    if radius == 4 and out_dtype == torch.float32:   # the former body
        assert torch.equal(cl.lookup_corr_pyramid_warp(pyr, coords, 4), want)


def test_k3_rejects_mismatched_levels(dev):
    pyr = [torch.randn(6, 2, 3, device=dev)]
    with pytest.raises(ValueError):
        cl.lookup_corr_pyramid(pyr, torch.zeros(1, 2, 2, 2, device=dev), 3)
    with pytest.raises(ValueError):
        cl.lookup_corr_pyramid([pyr[0].transpose(1, 2)],
                               torch.zeros(1, 2, 3, 2, device=dev), 3)
    coords = torch.zeros(1, 2, 3, 2, device=dev)
    with pytest.raises(ValueError):   # instantiated for RAFT's radii only
        cl.lookup_corr_pyramid(pyr, coords, 2)
    shifted = torch.randn(6 * 2 * 3 + 1, device=dev)[1:].reshape(6, 2, 3)
    with pytest.raises(ValueError):   # levels start 16-byte aligned
        cl.lookup_corr_pyramid([shifted], coords, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(3, 300, 128, device=dev, generator=g).to(dtype)
               for _ in range(3))
    out, lse = fa.flash_mhsa(q, k, v, 128 ** -0.5)
    want, want_lse = fa.flash_attention_plain(q, k, v, 128 ** -0.5)
    top = want.float().abs().max().item()
    tol = 2e-5 if dtype == torch.float32 else top * 2 ** -7
    assert (out.float() - want.float()).abs().max().item() <= tol
    assert (lse - want_lse).abs().max().item() <= 1e-4


RAGGED = [(3, 1), (3, 63), (3, 64), (3, 65), (3, 127), (3, 300)]


@pytest.mark.parametrize("n,l", RAGGED + [(1, 2340), (80, 2340)])
def test_k2_bf16_tensor_cores_match_plain(dev, n, l):
    """K2's bf16 tensor-core body at ragged L (64-row tile edges just
    inside and past L) and the main-path N = 80, L = 2340: one bf16 ulp of
    the largest output (the kernel rounds p against the running max, the
    plain version against the row max) and 1e-4 on the f32 lse."""
    g = torch.Generator(device=dev).manual_seed(l)
    q, k, v = (torch.randn(n, l, 128, device=dev, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    before = fa.flash_mhsa.launches
    out, lse = fa.flash_mhsa(q, k, v, 128 ** -0.5)
    assert fa.flash_mhsa.launches == before + 1
    want, want_lse = fa.flash_attention_plain(q, k, v, 128 ** -0.5)
    top = want.float().abs().max().item()
    assert out.dtype == torch.bfloat16
    assert (out.float() - want.float()).abs().max().item() <= top * 2 ** -7
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n,l", RAGGED + [(1, 900), (32, 900)])
def test_k5_bf16_tensor_cores_match_plain(dev, n, l):
    """K5's bf16 tensor-core body (and K4 beside it) at ragged L and the
    training shape N = 32, L = 900, on the plain K2's lse and dsum: one
    bf16 ulp of the largest entry, plus 1e-5 for gradients that vanish
    in exact arithmetic (at L = 1, dp = dsum) and hold f32 noise only."""
    g = torch.Generator(device=dev).manual_seed(l + 7)
    q, k, v, do = (torch.randn(n, l, 128, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    scale = 128 ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(-1)
    before = fa.flash_attention_dkv.launches
    got = (fa.flash_attention_dq(q, k, v, do, lse, dsum, scale),
           *fa.flash_attention_dkv(q, k, v, do, lse, dsum, scale))
    assert fa.flash_attention_dkv.launches == before + 1
    want = (fa.flash_attention_dq_plain(q, k, v, do, lse, dsum, scale),
            *fa.flash_attention_dkv_plain(q, k, v, do, lse, dsum, scale))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        top = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= \
            top * 2 ** -7 + 1e-5


@pytest.mark.parametrize("n,l", RAGGED + [(1, 900), (32, 900)])
def test_k4_bf16_tensor_cores_match_plain(dev, n, l):
    """K4's bf16 tensor-core body at ragged L and the training shape
    N = 32, L = 900, on the plain K2's lse and dsum. Tolerance, K5's: one
    bf16 ulp of the largest entry (the f32 sums of s, dp and dq run in
    other orders than the plain version's, and ds is rounded to bf16 from
    values that differ by that reassociation), plus 1e-5 for gradients
    that vanish in exact arithmetic (at L = 1, dp = dsum) and hold f32
    noise only."""
    g = torch.Generator(device=dev).manual_seed(l + 11)
    q, k, v, do = (torch.randn(n, l, 128, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    scale = 128 ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(-1)
    before = fa.flash_attention_dq.launches
    got = fa.flash_attention_dq(q, k, v, do, lse, dsum, scale)
    assert fa.flash_attention_dq.launches == before + 1
    want = fa.flash_attention_dq_plain(q, k, v, do, lse, dsum, scale)
    assert got.dtype == torch.bfloat16
    top = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= \
        top * 2 ** -7 + 1e-5


def test_k2_rejects_other_head_dims(dev):
    q = torch.randn(2, 50, 64, device=dev)
    with pytest.raises(ValueError):
        fa.flash_mhsa(q, q, q, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [10, 300])
def test_k4_k5_kernels_match_plain(dev, dtype, l):
    """dq, dk, dv from K4/K5 against their plain versions on the same lse
    and dsum, ragged L. f32: reassociation only; bf16 outputs: 1 ulp of
    the largest entry."""
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn(3, l, 128, device=dev, generator=g).to(dtype)
                   for _ in range(4))
    scale = 128 ** -0.5
    out, lse = fa.flash_mhsa(q, k, v, scale)
    dsum = (do.float() * out.float()).sum(-1)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    got = (fa.flash_attention_dq(q, k, v, do, lse, dsum, scale),
           *fa.flash_attention_dkv(q, k, v, do, lse, dsum, scale))
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = (fa.flash_attention_dq_plain(q, k, v, do, lse, dsum, scale),
            *fa.flash_attention_dkv_plain(q, k, v, do, lse, dsum, scale))
    for a, b in zip(got, want):
        assert a.dtype == dtype
        top = b.float().abs().max().item()
        tol = 1e-5 * max(1.0, top) if dtype == torch.float32 else top * 2 ** -7
        assert (a.float() - b.float()).abs().max().item() <= tol


def test_flash_attend_gradients_on_the_card(dev):
    """The FlashAttention Function (K2, K4, K5) against autograd of the
    plain forward on the card, f32; tolerance 1e-5."""
    g = torch.Generator(device=dev).manual_seed(3)
    base = [torch.randn(2, 2, 150, 128, device=dev, generator=g)
            for _ in range(4)]
    ours = [t.clone().requires_grad_() for t in base[:3]]
    ref = [t.clone().requires_grad_() for t in base[:3]]
    out = fa.flash_attend(*ours, 0.1)
    assert out.grad_fn is not None
    want = fa.flash_attention_plain(*(r.reshape(4, 150, 128) for r in ref),
                                    0.1)[0].reshape(out.shape)
    (out * base[3]).sum().backward()
    (want * base[3]).sum().backward()
    for a, b in zip(ours, ref):
        assert (a.grad - b.grad).abs().max().item() <= 1e-5


def _k6_operands(dev, video, gx, gy, holes, gms):
    return ([torch.from_numpy(a).to(dev).double() for a in (video, gx, gy)]
            + [torch.from_numpy(a).to(dev) for a in (holes, gms)])


# the stroke cell's clip (mask seed 0) and one 2x outpainting canvas frame
@pytest.mark.parametrize("kind,shape", [("strokes", (24, 240, 432)),
                                        ("ring", (1, 480, 864))])
def test_k6_matches_twin_and_splu(dev, kind, shape):
    video, gx, gy, holes, gms = case(kind, *shape)
    before = k6.poisson_pcg.launches
    got, left = tpoisson.poisson_blend_clip(video, gx, gy, holes, gms,
                                            torch.device(dev))
    assert k6.poisson_pcg.launches == before + 1
    want, want_left = splu_clip(video, gx, gy, holes, gms)
    np.testing.assert_array_equal(left, want_left)
    assert worst_filled_gap(got, want, holes, left) <= 1e-6
    ops = _k6_operands(dev, video, gx, gy, holes, gms)
    x, iters = k6.poisson_pcg(*ops, holes.reshape(len(holes), -1).sum(1)
                              ).result()
    x_twin, it_twin = k6.poisson_pcg_plain(*ops)
    assert np.abs(x - x_twin.cpu().numpy())[holes & ~left].max() <= 1e-7
    np.testing.assert_array_equal(x[~holes], video.astype(np.float64)[~holes])
    it_twin = it_twin.cpu().numpy()
    assert (iters > 0).all()
    assert np.abs(iters - it_twin).max() <= max(3, 0.05 * it_twin.max())


def test_k6_refuses_bad_operands(dev):
    video, gx, gy, holes, gms = case("square")
    img, gxt, gyt, hole, gm = _k6_operands(dev, video, gx, gy, holes, gms)
    counts = holes.reshape(2, -1).sum(1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        k6.poisson_pcg(img, gxt.cpu(), gyt, hole, gm, counts)
    with pytest.raises(TypeError, match="float32"):
        k6.poisson_pcg(img, gxt.float(), gyt, hole, gm, counts)
    strided = torch.cat([gyt, gyt], -1)[..., :3]
    with pytest.raises(ValueError, match="not contiguous"):
        k6.poisson_pcg(img, gxt, strided, hole, gm, counts)
    with pytest.raises(RuntimeError, match="another number of hole pixels"):
        k6.poisson_pcg(img, gxt, gyt, hole, gm, counts + 1).result()


def test_k6_unconverged_plane_raises(dev):
    ops = _k6_operands(dev, *case("ring"))
    solve = k6.poisson_pcg(*ops, ops[3].flatten(1).sum(1).tolist(),
                           max_iters=5)
    with pytest.raises(RuntimeError, match="did not converge within 5"):
        solve.result()


# the removal cells' flows, the 2x canvas's ring, a coarsest level too
# large for shared memory, a single level (no side of 32 px) and odd
# extents at every level
@pytest.mark.parametrize("kind,shape,shared", [
    ("strokes", (46, 240, 432), True), ("ring", (46, 480, 864), True),
    ("square", (4, 1280, 1280), False), ("square", (4, 24, 200), True),
    ("strokes", (6, 121, 203), True)])
def test_k7_matches_plain(dev, kind, shape, shared):
    planes, hole = k7_case(kind, *shape)
    assert k7.coarse_in_shared(*shape[1:], dev) == shared
    before = k7.diffusion_mg.launches
    got, mine = counted(k7.laplace_fill_planes, planes, hole)
    assert k7.diffusion_mg.launches == before + 1
    want, plain = counted(k7.laplace_fill_planes_plain, planes, hole)
    scale = planes.abs().max().item()
    assert (got - want)[hole].abs().max().item() <= 1e-4 * scale
    bits = got.view(torch.int32)[~hole]
    assert torch.equal(bits, planes.view(torch.int32)[~hole])
    assert abs(mine["pcg_iters"] - plain["pcg_iters"]) <= 2
    assert 0 < mine["pcg_iters"] < k7.MAX_ITERS
    assert plain["pcg_syncs"] == plain["pcg_iters"] + 1
    assert mine["pcg_syncs"] <= math.ceil(mine["pcg_iters"] / k7.CHUNK) + 2


def test_k7_is_deterministic(dev):
    planes, hole = k7_case("strokes", 46, 240, 432)
    a, ia = k7.diffusion_mg(planes, hole, plane_iters=True)
    b, ib = k7.diffusion_mg(planes, hole, plane_iters=True)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(ia, ib) and int(ia.max()) > 0


def test_k7_refuses_bad_operands(dev):
    planes, hole = k7_case("square", 2, 64, 96)
    with pytest.raises(TypeError, match="float32"):
        k7.diffusion_mg(planes.double(), hole)
    with pytest.raises(TypeError, match="bool"):
        k7.diffusion_mg(planes, hole.float())
    with pytest.raises(ValueError, match="not contiguous"):
        k7.diffusion_mg(planes.transpose(1, 2), hole.transpose(1, 2))
    with pytest.raises(RuntimeError, match="CUDA device"):
        k7.diffusion_mg(planes, hole.cpu())
    with pytest.raises(RuntimeError, match="CUDA device"):
        k7.laplace_fill_planes(planes, hole.cpu())
    with pytest.raises(ValueError, match="alike"):
        k7.diffusion_mg(planes, hole[:1].contiguous())
