"""Inputs of kernels K1-K5 at the shapes the port runs them, and each
kernel's check against its plain version (``check_k1`` ... ``check_k5``:
the tolerances live here and only here), shared by the card tests
(``test_torch_port_cuda.py``) and ``chip_smoke.py``'s timing table,
which checks every row on the inputs it times: the main path's 46 pairs
x 60x108 px (K1's features and coords, K3's all-pairs pyramids and
coords, with rows far outside every level), RAFT small's C 128 and r 3,
and q/k/v at the main path's, the outpainting canvas's, the exact
windows' and training's shapes. A check raises AssertionError on a miss
and returns its deviations. Imports no JAX."""

import numpy as np
import torch
import torch.nn.functional as F

from fgt_tpu_torch.ops import corr_fused as cf
from fgt_tpu_torch.ops import corr_lookup as cl
from fgt_tpu_torch.ops import flash_attention as fa

# s1 at 432x240: 46 pairs (23 forward, 23 backward) of the 864x480
# flows' 1/8 grid, 4 pyramid levels (60x108, 30x54, 15x27, 7x13)
MAIN = (46, 60, 108)
LEVELS = 4

HEAD_DIM = 128
SCALE = HEAD_DIM ** -0.5
# K2's (N, L): 5 windows x 4 groups x 4 heads of 13 frames x 10x18 tokens
K2_MAIN = (80, 2340)
# the outpainting canvas (480x864: 20x36 tokens a frame, window_batch 1,
# so N = 4 groups x 4 heads): the 24-frame probe's windows of 13 frames
# and the 208-frame probe's of 31
K2_CANVAS = ((16, 9360), (16, 22320))
# --exact_windows on 24 frames: windows of 8, 11, 12 and 13 frames
K2_EXACT_WINDOWS = tuple((16, 180 * t) for t in (8, 11, 12, 13))
# training: batch 2 x 4 groups x 4 heads of 5 frames x 10x18 tokens
K45_TRAIN = (32, 900)


def pixel_grid(b, h, w, device):
    """[b, h, w, 2] f32: each pixel's (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return torch.stack([xs, ys], -1).float()[None].repeat(b, 1, 1, 1)


def smooth_coords(b, h, w, gen, nodes=(4, 7), amp=8.0):
    """The pixel grid plus a smooth random flow: a low-resolution field
    of ``amp`` px, bilinearly upsampled. [b, h, w, 2] f32 (x, y) on the
    generator's device."""
    dev = gen.device
    grid = pixel_grid(b, h, w, dev)
    field = amp * torch.randn(b, 2, *nodes, device=dev, generator=gen)
    flow = F.interpolate(field, size=(h, w), mode="bilinear",
                         align_corners=True)
    return grid + flow.permute(0, 2, 3, 1)


def _coords(kind, gen, far):
    """Coords over ``far``'s [B, H, W]: ``noisy``, the pixel grid plus
    8 px of noise a pixel, rows 0-3 at 1e4 and 4-7 at -3e3; ``smooth``,
    :func:`smooth_coords`, rows 0-1 at 1e4. Marks the far rows in
    ``far``."""
    b, h, w = far.shape
    if kind == "smooth":
        coords = smooth_coords(b, h, w, gen)
        coords[:, :2] = 1e4
        far[:, :2] = True
        return coords
    coords = pixel_grid(b, h, w, gen.device) + 8 * torch.randn(
        b, h, w, 2, device=gen.device, generator=gen)
    coords[:, :4] = 1e4
    coords[:, 4:8] = -3e3
    far[:, :8] = True
    return coords


def k1_inputs(dtype, c, r, kind, device="cuda"):
    """K1 at the main-path shape with C channels: (f1 [46, 60, 108, C]
    in ``dtype``, the pooled pyramid of f2 as ``build_fmap_pyramid``
    stores it in ``dtype``, coords of ``kind``, far [46, 60, 108] bool:
    the pixels whose taps are all zero). On noisy coords level 0's bf16
    tile boxes overflow (the general route), on smooth ones they fit
    (the box route)."""
    g = torch.Generator(device=device).manual_seed(1 + c + r)
    b, h, w = MAIN
    f1 = torch.randn(b, h, w, c, device=device, generator=g).to(dtype)
    f2 = torch.randn(b, h, w, c, device=device, generator=g)
    pyr = cf.build_fmap_pyramid(f2, LEVELS, dtype=dtype)
    far = torch.zeros(MAIN, dtype=torch.bool, device=device)
    return f1, pyr, _coords(kind, g, far), far


def k3_inputs(dtype, levels=LEVELS, device="cuda"):
    """K3 at the main-path shape: (``levels`` random all-pairs maps
    [46·60·108, H_l, W_l] in ``dtype``, noisy coords with pixels on the
    right edge, straddling the left and the bottom edge, far)."""
    g = torch.Generator(device=device).manual_seed(3)
    b, h, w = MAIN
    pyr = [torch.randn(b * h * w, hl, wl, device=device, generator=g)
           .to(dtype) for hl, wl in cl.pyramid_sizes(h, w, levels)]
    far = torch.zeros(MAIN, dtype=torch.bool, device=device)
    coords = _coords("noisy", g, far)
    coords[:, 8, :, 0] = w - 1
    coords[:, 9, :, 0] = -0.5
    coords[:, 10, :, 1] = h - 0.75
    return pyr, coords, far


def k3_small_inputs(device="cuda"):
    """K3 at RAFT small's shape: (the bf16 all-pairs pyramid of one
    refine from C = 128 features at the main-path shape, smooth coords,
    far)."""
    g = torch.Generator(device=device).manual_seed(7)
    f1, f2 = (torch.randn(*MAIN, 128, device=device, generator=g)
              .to(torch.bfloat16) for _ in range(2))
    pyr = cl.build_corr_pyramid(f1, f2, LEVELS, dtype=torch.bfloat16)
    far = torch.zeros(MAIN, dtype=torch.bool, device=device)
    return pyr, _coords("smooth", g, far), far


def qkv(n, l, dtype, seed, count=3, device="cuda"):
    """``count`` random [n, l, 128] tensors in ``dtype``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(n, l, HEAD_DIM, device=device, generator=g)
                 .to(dtype) for _ in range(count))


def plain_chunk(l: int) -> int:
    """Sequences a call of K2's plain version takes at length ``l``: as
    many as keep the f32 [N, L, L] scores within ~2.2 GB (one at L
    22320)."""
    return max(1, int(2.2e9 // (4 * l * l)))


def k2_plain(q, k, v, scale):
    """K2's plain version over chunks of :func:`plain_chunk` sequences:
    (out, lse) as one call would give them."""
    step = plain_chunk(q.shape[1])
    if step >= q.shape[0]:
        return fa.flash_attention_plain(q, k, v, scale)
    parts = [fa.flash_attention_plain(q[s:s + step], k[s:s + step],
                                      v[s:s + step], scale)
             for s in range(0, q.shape[0], step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def k45_inputs(n, l, dtype, seed, forward=fa.flash_mhsa, device="cuda"):
    """K4's and K5's arguments: (q, k, v, dO, lse, dsum, scale), lse
    from ``forward`` and dsum = rowsum(dO · out)."""
    q, k, v, do = qkv(n, l, dtype, seed, 4, device)
    out, lse = forward(q, k, v, SCALE)
    dsum = (do.float() * out.float()).sum(-1)
    return q, k, v, do, lse, dsum, SCALE


def require(ok: bool, what: str) -> None:
    """Raise AssertionError with ``what`` unless ``ok``."""
    if not ok:
        raise AssertionError(what)


def held(label: str, got, want, limit: float) -> float:
    """max |got - want| (as f32), raising where it exceeds ``limit``."""
    err = (got.float() - want.float()).abs().max().item()
    require(err <= limit, f"{label}: max |kernel - plain| {err:.4g} > "
            f"{limit:.4g}")
    return err


def top(t) -> float:
    return t.float().abs().max().item()


def bf16_ulp(t) -> float:
    """One bf16 ulp of ``t``'s largest entry: where the kernel's f32 sums
    and the plain version's run in other orders, an output may round to
    the neighbouring bf16 value."""
    return top(t) * 2 ** -7


def check_k1(f1, pyr, coords, r, far) -> dict:
    """K1 on these inputs against its plain version: one launch, taps
    [B, H, W, levels·(2r+1)²] in level 0's dtype, within 1e-4·max(1,
    top) in f32 (reassociated C-term dots) or one bf16 ulp of the
    largest tap in bf16, exact zeros at the pixels ``far`` marks, and in
    bf16 the kernel's route counts equal to ``tile_routes``'. Returns
    {max_abs_err, and in bf16 routes}."""
    cf.reset_route_tiles()
    before = cf.lookup_corr_fused.launches
    got = cf.lookup_corr_fused(f1, pyr, coords, r)
    require(cf.lookup_corr_fused.launches == before + 1, "K1: not 1 launch")
    routes = cf.route_tiles()
    want = cf.lookup_corr_plain(f1, pyr, coords, r)
    shape = (*coords.shape[:3], len(pyr) * (2 * r + 1) ** 2)
    require(got.shape == shape and got.dtype == pyr[0].dtype,
            f"K1: taps {tuple(got.shape)} {got.dtype}")
    bf16 = pyr[0].dtype == torch.bfloat16
    limit = bf16_ulp(want) if bf16 else 1e-4 * max(1.0, top(want))
    out = dict(max_abs_err=held("K1", got, want, limit))
    require(not got[far].any(), "K1: nonzero taps at far coords")
    if bf16:
        want_routes = cf.tile_routes(coords, [lv.shape[1:3] for lv in pyr], r)
        require(routes == want_routes, f"K1: routes {routes} differ from "
                f"tile_routes' {want_routes}")
        out["routes"] = routes
    return out


def check_k2(q, k, v, scale) -> dict:
    """K2 on these inputs against its plain version (:func:`k2_plain`):
    one launch; out in q's dtype within 2e-5 in f32 (the online and the
    one-shot softmax reassociate) or one bf16 ulp of the largest output
    in bf16 (the kernel rounds p against the running max, the plain
    version against the row max); the f32 lse within 1e-4. Returns
    {max_abs_err, lse_err}."""
    before = fa.flash_mhsa.launches
    out, lse = fa.flash_mhsa(q, k, v, scale)
    require(fa.flash_mhsa.launches == before + 1, "K2: not 1 launch")
    want, want_lse = k2_plain(q, k, v, scale)
    require(out.dtype == q.dtype, f"K2: out {out.dtype}")
    limit = 2e-5 if q.dtype == torch.float32 else bf16_ulp(want)
    return dict(max_abs_err=held("K2", out, want, limit),
                lse_err=held("K2 lse", lse, want_lse, 1e-4))


def check_k3(pyr, coords, r, out_dtype, far) -> dict:
    """K3 on these inputs against its plain version: one launch, taps in
    ``out_dtype`` equal to the plain version's (the same products and
    sums, each rounded on its own; bf16 taps are the f32 taps rounded
    once), exact zeros at the pixels ``far`` marks. Returns
    {max_abs_err: 0.0}."""
    before = cl.lookup_corr_pyramid.launches
    got = cl.lookup_corr_pyramid(pyr, coords, r, out_dtype=out_dtype)
    require(cl.lookup_corr_pyramid.launches == before + 1, "K3: not 1 launch")
    want = cl.lookup_corr_pyramid_plain(pyr, coords, r, out_dtype)
    require(got.dtype == out_dtype, f"K3: taps {got.dtype}")
    require(torch.equal(got, want), "K3: taps differ from the plain "
            f"version's by up to {(got.float() - want.float()).abs().max()}")
    require(not got[far].any(), "K3: nonzero taps at far coords")
    return dict(max_abs_err=0.0)


def _check_k45(label, got, want, args, slack, autograd) -> dict:
    """``got`` against ``want`` (the plain versions' outputs), each in
    q's dtype: f32 within 1e-5·max(1, top) (reassociated sums), bf16
    within one ulp of the largest entry plus ``slack``; with
    ``autograd``, also against autograd of the plain forward, bf16
    within two ulps (its dsum comes from the unrounded output)."""
    q, k, v, do, _, _, scale = args
    f32 = q.dtype == torch.float32
    if autograd:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(
            fa.flash_attention_plain(*leaves, scale)[0], leaves, do)
        auto = auto[:1] if label == "K4" else auto[1:]
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        require(a.dtype == q.dtype, f"{label}: output {a.dtype}")
        limit = 1e-5 * max(1.0, top(b)) if f32 else bf16_ulp(b) + slack
        err = max(err, held(label, a, b, limit))
        if autograd:
            held(f"{label} vs autograd", a, auto[i],
                 limit if f32 else 2 * bf16_ulp(b))
    return dict(max_abs_err=err)


def check_k4(q, k, v, do, lse, dsum, scale, slack=0.0,
             autograd=False) -> dict:
    """K4 (dq) on these inputs against its plain version: one launch,
    the tolerances of :func:`_check_k45`. Returns {max_abs_err}."""
    args = (q, k, v, do, lse, dsum, scale)
    before = fa.flash_attention_dq.launches
    got = fa.flash_attention_dq(*args)
    require(fa.flash_attention_dq.launches == before + 1, "K4: not 1 launch")
    return _check_k45("K4", (got,), (fa.flash_attention_dq_plain(*args),),
                      args, slack, autograd)


def check_k5(q, k, v, do, lse, dsum, scale, slack=0.0,
             autograd=False) -> dict:
    """K5 (dk, dv) on these inputs against its plain version: one
    launch, the tolerances of :func:`_check_k45`. Returns
    {max_abs_err}."""
    args = (q, k, v, do, lse, dsum, scale)
    before = fa.flash_attention_dkv.launches
    got = fa.flash_attention_dkv(*args)
    require(fa.flash_attention_dkv.launches == before + 1,
            "K5: not 1 launch")
    return _check_k45("K5", got, fa.flash_attention_dkv_plain(*args), args,
                      slack, autograd)


def check_pyramid_tf32(device="cuda") -> dict:
    """The all-pairs pyramid of one refine at the main-path shape (C =
    256, bf16 storage) from bf16 features, whose f32 product runs on
    TF32 tensor cores (exact for bf16-valued inputs), against the same
    values as f32 features (the full-f32 product): within one bf16 ulp
    at |corr| ~ 16, the largest maps. Returns {max_abs_err}."""
    g = torch.Generator(device=device).manual_seed(5)
    f1, f2 = (torch.randn(*MAIN, 256, device=device, generator=g)
              .to(torch.bfloat16) for _ in range(2))
    tf32 = cl.build_corr_pyramid(f1, f2, LEVELS, dtype=torch.bfloat16)
    f32 = cl.build_corr_pyramid(f1.float(), f2.float(), LEVELS,
                                dtype=torch.bfloat16)
    return dict(max_abs_err=max(held("TF32 pyramid", a, b, 2 ** -7 * 16)
                                for a, b in zip(tf32, f32)))


def check_refine_bf16(device="cuda") -> dict:
    """RAFT's bf16 refine on a 64x64 pair (8x8 features; levels 8x8, 4x4,
    2x2, 1x1) at full width, random weights from seed 0, 20 iterations
    with K1 and then with its plain version in its place. K1 launches 20
    times and takes its box route. The bf16 GRU carries a one-ulp tap
    difference through 20 iterations; on the CPU, flipping 0.5% of the
    taps by one bf16 ulp every iteration moved the upsampled flow by
    0.45% of its largest value at most and 0.1% on the mean, so max
    |diff| <= 2^-5 and mean |diff| <= 2^-8 of the largest |flow|.
    Returns {max_abs_err, mean_abs_err, routes}."""
    from fgt_tpu_torch.models import raft as raft_mod
    from portbench.traffic import panning_background

    frames = panning_background(np.random.RandomState(0), 2, 64, 64, 2)
    model = raft_mod.init_raft(raft_mod.RAFT(),
                               torch.Generator().manual_seed(0))
    model = model.to(device, torch.bfloat16).eval()
    flows = []
    try:
        with torch.no_grad():
            fmap, net, inp = model.encode(torch.from_numpy(frames).to(device))
            for lookup in (cf.lookup_corr_fused, cf.lookup_corr_plain):
                raft_mod.lookup_corr_fused = lookup
                cf.reset_route_tiles()
                before = cf.lookup_corr_fused.launches
                flows.append(model.refine(fmap[:1], fmap[1:], net[:1],
                                          inp[:1], 20)[1].float())
                if lookup is cf.lookup_corr_fused:
                    routes = cf.route_tiles()
                    launches = cf.lookup_corr_fused.launches - before
    finally:
        raft_mod.lookup_corr_fused = cf.lookup_corr_fused
    require(launches == 20 and routes["box"] > 0,
            f"RAFT refine: K1 launches {launches}, routes {routes}")
    flow_top = top(flows[1])
    diff = (flows[0] - flows[1]).abs()
    mean = diff.mean().item()
    require(mean <= flow_top * 2 ** -8, f"RAFT refine: mean |K1 - plain| "
            f"{mean:.4g} > {flow_top * 2 ** -8:.4g}")
    return dict(max_abs_err=held("RAFT refine", flows[0], flows[1],
                                 flow_top * 2 ** -5),
                mean_abs_err=mean, routes=routes)
