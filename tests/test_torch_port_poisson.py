"""s5's Poisson blending on the clip path (``pipeline/poisson.
poisson_blend_clip``, kernel K6's plain twin on the CPU) against the
per-frame scipy ``splu`` solve (``pipeline/poisson.poisson_blend``), at
small shapes: holes cut from the stroke cell's moving strokes, a 56x56
square and an outpainting canvas's ring, each with gradient-masked
patches, one of them a closed ring of masked gradients whose inside
reaches no known pixel."""

import numpy as np
import pytest
import torch
from scipy import sparse

from fgt_tpu_torch.ops import poisson as k6
from fgt_tpu_torch.pipeline import poisson as tpoisson
from fgt_tpu_torch.utils import profiling
from torch_port_poisson_cases import case, splu_clip


def _counted(fn):
    profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        with profiling.span("s5"):
            out = fn()
    finally:
        profiling.enable_spans(False)
    (rec,) = profiling.spans()
    return out, rec["counters"]


@pytest.mark.parametrize("kind", ["strokes", "square", "ring"])
def test_twin_matches_splu_on_filled_pixels(kind):
    video, gx, gy, holes, gms = case(kind)
    (want, want_left), want_c = _counted(
        lambda: splu_clip(video, gx, gy, holes, gms))
    (got, got_left), got_c = _counted(
        lambda: tpoisson.poisson_blend_clip(video, gx, gy, holes, gms,
                                            torch.device("cpu")))
    np.testing.assert_array_equal(got_left, want_left)
    # the closed ring's inside is left to FGT
    assert (got_left & ~gms).any() and not (got_left & ~holes).any()
    assert got_c["poisson_px"] == want_c["poisson_px"] == int(holes.sum())
    assert 0 < got_c["poisson_iters"] < k6.MAX_ITERS
    filled = holes & ~got_left
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if not holes[i].any():
            np.testing.assert_array_equal(g, video[i])
            continue
        assert np.abs(g - w)[filled[i]].max() <= 1e-6
        np.testing.assert_array_equal(g[~holes[i]], w[~holes[i]])


@pytest.mark.parametrize("kind", ["strokes", "square", "ring"])
def test_twin_operator_is_the_normal_equations(kind):
    """The twin's diagonal, right-hand side and couplings equal
    ``_PoissonPlan``'s AᵀA + 1e-8·I and Aᵀb on every frame."""
    video, gx, gy, holes, gms = case(kind)
    t = [torch.from_numpy(a).double() for a in (video, gx, gy)]
    diag, rhs, couple = k6._system(*t, torch.from_numpy(holes),
                                   torch.from_numpy(gms))
    h, w = holes.shape[1:]
    rng = np.random.RandomState(3)
    for i in np.flatnonzero(holes.reshape(len(holes), -1).any(1)):
        plan = tpoisson._PoissonPlan(holes[i], gms[i])
        ata = (plan.A.T @ plan.A + 1e-8 * sparse.eye(plan.py.size)).tocsr()
        gxp = np.zeros((h, w, 3))
        gyp = np.zeros((h, w, 3))
        gxp[:, :w - 1] = gx[i][:, :w - 1]
        gyp[:h - 1] = gy[i][:h - 1]
        atb = plan.A.T @ plan.rhs(video[i].astype(np.float64), gxp, gyp)
        sel = (slice(None), plan.py, plan.px)
        np.testing.assert_array_equal(diag[i][sel].T.numpy(),
                                      np.repeat(ata.diagonal()[:, None], 3, 1))
        np.testing.assert_allclose(rhs[i][sel].T.numpy(), atb, rtol=0,
                                   atol=1e-12)
        v = rng.randn(h, w)
        v[~holes[i]] = 0
        vt = torch.from_numpy(v)
        off = sum(torch.where(c[0], k6._shift(vt, dy, dx), 0.0)
                  for c, (dy, dx) in zip([cc[i] for cc in couple],
                                         ((0, 1), (1, 0), (0, -1), (-1, 0))))
        mv = diag[i, 0] * vt - 2.0 * off
        np.testing.assert_allclose(mv.numpy()[plan.py, plan.px],
                                   ata @ v[plan.py, plan.px], rtol=0,
                                   atol=1e-12)


def test_unconverged_plane_raises():
    video, gx, gy, holes, gms = case("ring")
    solve = k6.poisson_pcg(
        *(torch.from_numpy(a).double() for a in (video, gx, gy)),
        torch.from_numpy(holes), torch.from_numpy(gms),
        holes.reshape(2, -1).sum(1), max_iters=5)
    with pytest.raises(RuntimeError, match="did not converge within 5"):
        solve.result()


@pytest.mark.parametrize("kind", ["strokes", "noise_0.3", "noise_0.6",
                                  "rings"])
def test_fill_holes_matches_scipy_per_frame(kind):
    """The label pass of the card's s5 fills what scipy's
    ``binary_fill_holes`` fills in each frame."""
    import scipy.ndimage

    rng = np.random.RandomState(4)
    if kind == "strokes":
        masks = case("strokes", 6, 72, 128)[3]
    elif kind == "rings":
        masks = np.zeros((3, 40, 52), bool)
        for i in range(3):        # closed rings, one cut open, one on a border
            masks[i, 5:20, 6:24] = True
            masks[i, 7:18, 8:22] = False
            masks[i, 25:40, 30:50] = True
            masks[i, 27:40, 32:48] = False
            masks[i, 12, 6:8] = i == 1
    else:
        masks = rng.rand(4, 33, 47) < float(kind.split("_")[1])
    want = np.stack([scipy.ndimage.binary_fill_holes(m) for m in masks])
    np.testing.assert_array_equal(tpoisson.fill_holes(masks), want)
    assert (want & ~masks).any() or kind == "noise_0.3"
