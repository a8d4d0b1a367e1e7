"""The port's CUDA kernels (K1-K7) against their plain versions, at small
shapes and at the shapes the port runs them. Inputs and checks (each
kernel's tolerances) come from ``torch_port_kernel_cases.py``,
``torch_port_poisson_cases.py`` and ``torch_port_diffusion_cases.py``,
whose checks ``chip_smoke.py`` also makes on the inputs it times. These
need a GPU and nvcc: marked ``cuda``; they skip on machines without a
card and run there with

    python -m pytest tests/test_torch_port_cuda.py -m cuda
"""

import pytest
import torch

import torch_port_kernel_cases as kc
from fgt_tpu_torch.ops import corr_fused as cf
from fgt_tpu_torch.ops import corr_lookup as cl
from fgt_tpu_torch.ops import diffusion as k7
from fgt_tpu_torch.ops import flash_attention as fa
from fgt_tpu_torch.ops import poisson as k6
from torch_port_diffusion_cases import case as k7_case
from torch_port_diffusion_cases import check_k7
from torch_port_poisson_cases import case, check_k6, k6_operands

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("dtype,c,radius,levels,main", [
    (torch.float32, 64, 4, 4, False), (torch.bfloat16, 256, 4, 4, False),
    (torch.float32, 32, 2, 2, False), (torch.float32, 128, 3, 4, False),
    (torch.bfloat16, 128, 3, 4, False), (torch.float32, 256, 4, 4, True)])
def test_k1_kernel_matches_plain(dev, dtype, c, radius, levels, main):
    """K1 against its plain version at 2 x 15x21 px, and in f32 (the
    --alternate_corr body) at the main-path shape on noisy coords."""
    if main:
        f1, pyr, coords, far = kc.k1_inputs(dtype, c, radius, "noisy", dev)
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        f1 = torch.randn(2, 15, 21, c, device=dev, generator=g).to(dtype)
        f2 = torch.randn(2, 15, 21, c, device=dev, generator=g)
        pyr = cf.build_fmap_pyramid(f2, levels, dtype=dtype)
        coords = torch.rand(2, 15, 21, 2, device=dev, generator=g) * 24 - 2
        coords[0, 0] = 1e4
        far = torch.zeros(2, 15, 21, dtype=torch.bool, device=dev)
        far[0, 0] = True
    kc.check_k1(f1, pyr, coords, radius, far)


@pytest.mark.parametrize("kind,c,main", [
    ("smooth", 256, False), ("noisy", 256, False), ("smooth", 64, False),
    ("noisy", 128, False), ("smooth", 256, True), ("noisy", 256, True),
    ("smooth", 128, True), ("noisy", 128, True)])
def test_k1_bf16_tile_routes_match_plain(dev, kind, c, main):
    """K1's bf16 body (bf16 level 0, f32 coarser levels) against its plain
    version at odd level sizes (45x75 -> 22x37 -> 11x18 -> 5x9, the
    image's right and bottom tiles partial), with far coords in some
    tiles, and at the main-path shape (r 4 at C 256, RAFT small's r 3 at
    C 128): ``check_k1``'s one bf16 ulp (the kernel's f32 sums,
    tensor-core products and hi + lo for the f32 levels, run in other
    orders than the plain version's), exact zeros at far coords, route
    counts equal to tile_routes'. At 45x75 a smooth flow keeps every tile
    on the box route and per-pixel noise sends most of level 0's tiles
    to the general route."""
    r = 3 if main and c == 128 else 4
    if main:
        f1, pyr, coords, far = kc.k1_inputs(torch.bfloat16, c, r, kind, dev)
    else:
        gen = torch.Generator().manual_seed(c + len(kind))
        b, h, w = 2, 45, 75
        f1 = torch.randn(b, h, w, c, generator=gen).to(torch.bfloat16)
        f2 = torch.randn(b, h, w, c, generator=gen)
        coords = kc.smooth_coords(b, h, w, gen, nodes=(3, 4),
                                  amp=8.0 if kind == "smooth" else 0.0)
        if kind == "noisy":
            coords = coords + 8 * torch.randn(b, h, w, 2, generator=gen)
        far = torch.zeros(b, h, w, dtype=torch.bool)
        far[0, :3] = True                        # far out of range
        far[1, 40:, 64:] = True                  # a corner tile far off
        coords[0, :3] = 1e4
        coords[1, 40:, 64:] = -3e3
        f1, f2, coords, far = (t.to(dev) for t in (f1, f2, coords, far))
        pyr = cf.build_fmap_pyramid(f2, 4, dtype=torch.bfloat16)
    routes = kc.check_k1(f1, pyr, coords, r, far)["routes"]
    if main:
        return
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
    coords = kc.smooth_coords(b, h, w, gen, nodes=(3, 4),
                              amp=8.0 if kind == "smooth" else 0.0)
    if kind == "noisy":
        coords = coords + 8 * torch.randn(b, h, w, 2, generator=gen)
    coords[0, :2] = 1e4
    far = torch.zeros(b, h, w, dtype=torch.bool)
    far[0, :2] = True
    f1, f2, coords, far = (t.to(dev) for t in (f1, f2, coords, far))
    pyr = cf.build_fmap_pyramid(f2, 4, dtype=torch.bfloat16)
    routes = kc.check_k1(f1, pyr, coords, r, far)["routes"]
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
@pytest.mark.parametrize("inputs,dtype,radius,levels,h,w", [
    ("uniform", torch.float32, 4, 4, 15, 21),
    ("uniform", torch.bfloat16, 4, 4, 15, 21),
    ("uniform", torch.float32, 3, 4, 9, 13),
    ("uniform", torch.bfloat16, 3, 3, 12, 20),
    ("uniform", torch.float32, 3, 2, 5, 7),
    ("uniform", torch.bfloat16, 4, 4, 60, 108),
    ("uniform", torch.float32, 3, 4, 60, 108),
    ("uniform", torch.bfloat16, 3, 4, 60, 108),
    ("main", torch.float32, 4, 4, 60, 108),
    ("main", torch.float32, 3, 4, 60, 108),
    ("main", torch.bfloat16, 4, 4, 60, 108),
    ("main", torch.bfloat16, 3, 4, 60, 108),
    ("raft_small", torch.bfloat16, 3, 4, 60, 108)])
def test_k3_kernel_matches_plain(dev, inputs, dtype, radius, levels, h, w,
                                 out_dtype):
    """K3 against its plain version: the same products and sums, each
    rounded on its own, so the taps are equal (f32 and bf16 storage; bf16
    taps are the f32 taps rounded once); pixels far outside every level
    give exact zeros. On 2 pairs with coords uniform over the level and
    3 px past it (at 60x108 each persistent warp walks several pixels
    through its two-slot ring), and on the main path's 46 pairs: random
    maps with noisy coords on and past the level edges, and RAFT small's
    pyramid built from C = 128 features with a smooth flow."""
    if inputs == "main":
        pyr, coords, far = kc.k3_inputs(dtype, levels, dev)
    elif inputs == "raft_small":
        pyr, coords, far = kc.k3_small_inputs(dev)
    else:
        g = torch.Generator(device=dev).manual_seed(4)
        n = 2 * h * w
        pyr = [torch.randn(n, hl, wl, device=dev, generator=g).to(dtype)
               for hl, wl in cl.pyramid_sizes(h, w, levels)]
        coords = torch.rand(2, h, w, 2, device=dev, generator=g) * (w + 6) - 3
        coords[0, 0] = 1e4
        coords[0, 1] = -3e3
        coords[1, 1, :, 0] = w - 1
        coords[1, 2, :, 0] = -0.5
        far = torch.zeros(2, h, w, dtype=torch.bool, device=dev)
        far[0, :2] = True
    kc.check_k3(pyr, coords, radius, out_dtype, far)


def test_corr_pyramid_tf32_product_matches_f32(dev):
    """``check_pyramid_tf32``: the main-path all-pairs pyramid from bf16
    features (TF32 product) against the full-f32 product."""
    kc.check_pyramid_tf32(dev)


def test_raft_refine_bf16_k1_matches_plain(dev):
    """``check_refine_bf16``: RAFT's bf16 refine on a 64x64 pair, 20
    iterations with K1 (its box route) and with its plain version."""
    kc.check_refine_bf16(dev)


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


@pytest.mark.parametrize("dtype,n,l", [
    (torch.float32, 3, 300), (torch.bfloat16, 3, 300),
    *((torch.float32, n, l) for n, l in (kc.K2_MAIN,) + kc.K2_EXACT_WINDOWS)])
def test_k2_kernel_matches_plain(dev, dtype, n, l):
    """K2 against its plain version (``check_k2``), in f32 also at the
    main path's and the exact windows' shapes."""
    kc.check_k2(*kc.qkv(n, l, dtype, 1, device=dev), kc.SCALE)


RAGGED = [(3, 1), (3, 63), (3, 64), (3, 65), (3, 127), (3, 300)]


@pytest.mark.parametrize("n,l", RAGGED + [(4, 65), (1, 2340), kc.K2_MAIN,
                                 *kc.K2_EXACT_WINDOWS, *kc.K2_CANVAS])
def test_k2_bf16_tensor_cores_match_plain(dev, n, l):
    """K2's bf16 tensor-core body at ragged L (64-row tile edges just
    inside and past L), the main-path N = 80, L = 2340, the exact
    windows' and the outpainting canvas's shapes (N = 16 at L = 9360 and
    22320, the plain version in chunks of N whose scores fit):
    ``check_k2``'s one bf16 ulp and 1e-4 on the f32 lse."""
    kc.check_k2(*kc.qkv(n, l, torch.bfloat16, l, device=dev), kc.SCALE)


@pytest.mark.parametrize("n,l", RAGGED + [(4, 65), (1, 900), kc.K45_TRAIN])
def test_k5_bf16_tensor_cores_match_plain(dev, n, l):
    """K5's bf16 tensor-core body (and K4 beside it) at ragged L and the
    training shape N = 32, L = 900, on the plain K2's lse and dsum: one
    bf16 ulp of the largest entry, plus 1e-5 at L = 1, where gradients
    vanish in exact arithmetic (dp = dsum) and hold f32 noise only."""
    args = kc.k45_inputs(n, l, torch.bfloat16, l + 7,
                         fa.flash_attention_plain, dev)
    slack = 1e-5 if l == 1 else 0.0
    kc.check_k5(*args, slack=slack)
    kc.check_k4(*args, slack=slack)


@pytest.mark.parametrize("n,l", RAGGED + [(1, 900), (32, 900)])
def test_k4_bf16_tensor_cores_match_plain(dev, n, l):
    """K4's bf16 tensor-core body at ragged L and the training shape
    N = 32, L = 900, on the plain K2's lse and dsum. Tolerance, K5's: one
    bf16 ulp of the largest entry (the f32 sums of s, dp and dq run in
    other orders than the plain version's, and ds is rounded to bf16 from
    values that differ by that reassociation), plus 1e-5 for gradients
    that vanish in exact arithmetic (at L = 1, dp = dsum) and hold f32
    noise only."""
    kc.check_k4(*kc.k45_inputs(n, l, torch.bfloat16, l + 11,
                               fa.flash_attention_plain, dev), slack=1e-5)


def test_k2_rejects_other_head_dims(dev):
    q = torch.randn(2, 50, 64, device=dev)
    with pytest.raises(ValueError):
        fa.flash_mhsa(q, q, q, 0.125)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,l", [(3, 10), (3, 300), kc.K45_TRAIN])
def test_k4_k5_kernels_match_plain(dev, dtype, n, l):
    """dq, dk, dv from K4/K5 against their plain versions on the same lse
    and dsum (K2's), at ragged L and the training shape, and against
    autograd of the plain forward (``check_k4``, ``check_k5``)."""
    args = kc.k45_inputs(n, l, dtype, 2, device=dev)
    kc.check_k4(*args, autograd=True)
    kc.check_k5(*args, autograd=True)


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


# the removal cells' clips (the stroke cell's mask seed 0, a 56x56
# square) and one 2x outpainting canvas frame
@pytest.mark.parametrize("kind,shape", [("strokes", (24, 240, 432)),
                                        ("square", (24, 240, 432)),
                                        ("ring", (1, 480, 864))])
def test_k6_matches_twin_and_splu(dev, kind, shape):
    check_k6(*case(kind, *shape), dev)


def test_k6_refuses_bad_operands(dev):
    video, gx, gy, holes, gms = case("square")
    img, gxt, gyt, hole, gm, counts = k6_operands(video, gx, gy, holes, gms,
                                                  dev)
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
    ops = k6_operands(*case("ring"), dev)
    solve = k6.poisson_pcg(*ops[:5], ops[3].flatten(1).sum(1).tolist(),
                           max_iters=5)
    with pytest.raises(RuntimeError, match="did not converge within 5"):
        solve.result()


# the removal cells' flows, the 2x canvas's ring, a coarsest level too
# large for shared memory, a single level (no side of 32 px) and odd
# extents at every level
@pytest.mark.parametrize("kind,shape,shared", [
    ("strokes", (46, 240, 432), True), ("square", (46, 240, 432), True),
    ("ring", (46, 480, 864), True),
    ("square", (4, 1280, 1280), False), ("square", (4, 24, 200), True),
    ("strokes", (6, 121, 203), True)])
def test_k7_matches_plain(dev, kind, shape, shared):
    planes, hole = k7_case(kind, *shape)
    assert k7.coarse_in_shared(*shape[1:], dev) == shared
    check_k7(planes, hole)


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
