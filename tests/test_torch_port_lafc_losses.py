"""Stage-1 training's warp and losses in the PyTorch port vs the JAX
package, on the CPU, in f32, with numpy inputs from a seed:

* ``core/warp.py``: ``image_warp`` values and gradients with respect to
  the flow and the image, on random flows and on integer flows including
  zero (where a ``grid_sample`` warp's normalise/unnormalise round trip
  flips ``floor`` and moves the flow gradient); ``bilinear_sampler``,
  ``forward_warp_splat`` and ``reverse_flow``;
* every flow, census, edge and consistency loss of
  ``fgt_tpu/train/losses.py`` (an all-zero mask, an all-zero edge map
  and census taps at the border included), ``edge_accuracy`` with no
  positives, and the global-norm clip against optax's;
* the VGG19 taps, the perceptual and the style loss through
  ``convert.weights.vgg19_mapping``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fgt_tpu.core import warp as jwarp
from fgt_tpu.train import losses as jlosses
from fgt_tpu.train import perceptual as jperc
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.core import warp as twarp
from fgt_tpu_torch.train import losses as tlosses
from fgt_tpu_torch.train import perceptual as tperc
from fgt_tpu_torch.train.schedules import clip_grad_global_norm

torch.set_num_threads(1)

B, H, W = 2, 12, 16


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _close(got, want, rtol, err_msg=""):
    """``got`` within ``rtol`` of the largest |want|, elementwise."""
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _flows(kind, rng, shape=(B, H, W, 2)):
    if kind == "random":
        return (rng.randn(*shape) * 3).astype(np.float32)
    if kind == "zero":
        return np.zeros(shape, np.float32)
    return rng.randint(-3, 4, shape).astype(np.float32)   # integer


# ------------------------------------------------------------------- warp

@pytest.mark.parametrize("kind", ["random", "integer", "zero"])
def test_image_warp_values_and_gradients_match_jax(kind):
    """Values to 1e-6 of the largest value; gradients with respect to
    the flow and the image (of sum(out * g)) to 1e-5 of the largest. On
    integer and zero flows every coordinate sits on a pixel, where
    ``floor`` decides which taps the flow gradient sees."""
    rng = np.random.RandomState({"random": 0, "integer": 1, "zero": 2}[kind])
    img = rng.rand(B, H, W, 3).astype(np.float32)
    flow = _flows(kind, rng)
    g = rng.randn(B, H, W, 3).astype(np.float32)

    def f(im, fl):
        return jnp.sum(jwarp.image_warp(im, fl) * g)

    want = jwarp.image_warp(jnp.asarray(img), jnp.asarray(flow))
    jg_img, jg_flow = jax.grad(f, argnums=(0, 1))(jnp.asarray(img),
                                                  jnp.asarray(flow))
    ti, tf = _t(img, True), _t(flow, True)
    out = twarp.image_warp(ti, tf)
    _close(out, want, 1e-6)
    (out * _t(g)).sum().backward()
    _close(tf.grad, jg_flow, 1e-5, "flow gradient")
    _close(ti.grad, jg_img, 1e-5, "image gradient")
    if kind != "random":        # the flow gradient is not all zero
        assert np.abs(np.asarray(jg_flow)).max() > 0.1


def test_grid_sample_warp_fails_the_integer_flow_check():
    """The integer-flow check above rejects a ``grid_sample`` warp
    (align_corners=True, zeros): its values agree, its flow gradient at
    zero flow does not."""
    rng = np.random.RandomState(3)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    g = rng.randn(B, H, W, 3).astype(np.float32)
    flow = np.zeros((B, H, W, 2), np.float32)
    _, jg_flow = jax.grad(
        lambda im, fl: jnp.sum(jwarp.image_warp(im, fl) * g),
        argnums=(0, 1))(jnp.asarray(img), jnp.asarray(flow))
    tf = _t(flow, True)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    gx = 2 * (xs + tf[..., 0]) / (W - 1) - 1
    gy = 2 * (ys + tf[..., 1]) / (H - 1) - 1
    out = F.grid_sample(_t(img).permute(0, 3, 1, 2),
                        torch.stack([gx, gy], -1), align_corners=True,
                        padding_mode="zeros").permute(0, 2, 3, 1)
    _close(out, img, 1e-5)
    (out * _t(g)).sum().backward()
    with pytest.raises(AssertionError):
        _close(tf.grad, jg_flow, 1e-5)


def test_bilinear_sampler_matches_jax():
    """Coordinates inside, on and past the border; to 1e-6."""
    rng = np.random.RandomState(4)
    img = rng.rand(B, H, W, 5).astype(np.float32)
    coords = np.stack([rng.uniform(-2, W + 1, (B, 40)),
                       rng.uniform(-2, H + 1, (B, 40))], -1)
    coords[:, :8] = np.round(coords[:, :8])
    coords = coords.astype(np.float32)
    want = jwarp.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords))
    _close(twarp.bilinear_sampler(_t(img), _t(coords)), want, 1e-6)


@pytest.mark.parametrize("kind", ["random", "integer"])
def test_forward_warp_splat_and_reverse_flow_match_jax(kind):
    """The splat's sums and weights and the reversed flow, to 1e-5 of
    the largest value (scatter-adds reassociated; on the card the order
    of ``index_add_``'s atomics is free)."""
    rng = np.random.RandomState(5)
    flow = _flows(kind, rng)
    data = rng.randn(B, H, W, 3).astype(np.float32)
    acc, wsum = jwarp.forward_warp_splat(jnp.asarray(flow), jnp.asarray(data))
    got_acc, got_w = twarp.forward_warp_splat(_t(flow), _t(data))
    _close(got_acc, acc, 1e-5)
    _close(got_w, wsum, 1e-5)
    _close(twarp.reverse_flow(_t(flow)),
           jwarp.reverse_flow(jnp.asarray(flow)), 1e-5)


# ----------------------------------------------------------------- losses

def _loss_inputs(seed, mask_kind="holes", edge_kind="sparse"):
    rng = np.random.RandomState(seed)
    d = {
        "flow": (rng.randn(B, H, W, 2) * 2).astype(np.float32),
        "gt": (rng.randn(B, H, W, 2) * 2).astype(np.float32),
        "cur": rng.rand(B, H, W, 3).astype(np.float32),
        "shift": rng.rand(B, H, W, 3).astype(np.float32),
        "mask": (rng.rand(B, H, W, 1) > 0.6).astype(np.float32),
        "edge_pred": (1 / (1 + np.exp(-rng.randn(B, H, W, 1)))).astype(
            np.float32),
        "edge_gt": (rng.rand(B, H, W, 1) > 0.85).astype(np.float32),
    }
    if mask_kind == "zero":
        d["mask"][:] = 0
    if edge_kind == "zero":
        d["edge_gt"][:] = 0
    return d


_LOSSES = {
    "charbonnier": lambda m, d: m.charbonnier(d["flow"]),
    "charbonnier_masked": lambda m, d: m.charbonnier(d["flow"], d["mask"]),
    "smoothness": lambda m, d: m.smoothness_loss(d["flow"], d["mask"]),
    "second_order": lambda m, d: m.second_order_loss(d["flow"], d["mask"]),
    "ternary_transform": lambda m, d: m.ternary_transform(d["cur"]),
    "hamming": lambda m, d: m.hamming_distance(
        m.ternary_transform(d["cur"]), m.ternary_transform(d["shift"])),
    "ternary_loss": lambda m, d: m.ternary_loss(
        d["flow"], d["gt"], d["mask"], d["cur"], d["shift"]),
    "edge_loss": lambda m, d: m.edge_loss(d["edge_pred"], d["edge_gt"]),
    "outgoing_mask": lambda m, d: m.create_outgoing_mask(d["flow"]),
    "fb_consistency": lambda m, d: m.fb_consistency_loss(
        d["flow"], -d["flow"] * 0.9, d["gt"], -d["gt"]),
}


@pytest.mark.parametrize("name", sorted(_LOSSES))
@pytest.mark.parametrize("mask_kind,edge_kind", [("holes", "sparse"),
                                                 ("zero", "zero")])
def test_losses_match_jax(name, mask_kind, edge_kind):
    """Each loss (or transform) at 1e-6 relative in f32, elementwise
    against the largest |value| for the arrays; also with an all-zero
    mask and an all-zero edge map."""
    d = _loss_inputs(7, mask_kind, edge_kind)
    fn = _LOSSES[name]
    want = fn(jlosses, {k: jnp.asarray(v) for k, v in d.items()})
    got = fn(tlosses, {k: _t(v) for k, v in d.items()})
    _close(got, want, 1e-6, name)


def test_census_taps_at_the_border_read_minus_the_centre():
    """Zero padding: at pixel (0, 0) the taps above and left read 0, so
    their raw difference is -I (soft-normalized); same in both."""
    rng = np.random.RandomState(8)
    img = rng.rand(1, 5, 6, 3).astype(np.float32)
    want = np.asarray(jlosses.ternary_transform(jnp.asarray(img)))
    got = tlosses.ternary_transform(_t(img)).numpy()
    _close(got, want, 1e-6)
    gray = (img[0, 0, 0] @ np.array([0.299, 0.587, 0.110])) * 255
    corner = -gray / np.sqrt(0.81 + gray ** 2)
    for tap in (0, 1, 2, 3, 6):          # rows or columns past the border
        np.testing.assert_allclose(got[0, 0, 0, tap], corner, rtol=1e-6)


@pytest.mark.parametrize("case", ["mixed", "no_positives", "no_selected"])
def test_edge_accuracy_matches_jax(case):
    """(precision, recall), exact; 1 where there is nothing to count."""
    d = _loss_inputs(9)
    pred, gt = d["edge_pred"], d["edge_gt"]
    if case == "no_positives":
        gt = np.zeros_like(gt)
    if case == "no_selected":
        pred = np.zeros_like(pred)
    want = jlosses.edge_accuracy(jnp.asarray(pred), jnp.asarray(gt))
    got = tlosses.edge_accuracy(_t(pred), _t(gt))
    for a, b in zip(got, want):
        assert float(a) == float(b)
    if case != "mixed":
        assert float(got[1 if case == "no_positives" else 0]) == 1.0


@pytest.mark.parametrize("scale", [0.01, 100.0])
def test_global_norm_clip_matches_optax(scale):
    """Below max_norm the gradients stay as they are (bit for bit);
    above it they scale by max_norm / norm with no epsilon, to 1e-6."""
    rng = np.random.RandomState(10)
    grads = [(rng.randn(*s) * scale).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(10.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = _t(g)
    clip_grad_global_norm(params, 10.0)
    for p, w, g in zip(params, want, grads):
        if scale < 1:
            np.testing.assert_array_equal(p.grad.numpy(), g)
        _close(p.grad, w, 1e-6)


# ------------------------------------------------------------ perceptual

@pytest.fixture(scope="module")
def vgg_pair():
    jm = jperc.VGG19Features()
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    port = tperc.VGG19Features()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.vgg19_mapping()))
    return jm, variables, port


def test_vgg19_taps_and_perceptual_losses_match_jax(vgg_pair):
    """relu1_1 .. relu5_1 on a 2x32x32 image through the mapping, each
    to 1e-4 of its largest feature; perceptual_loss and style_loss to
    1e-4 relative."""
    jm, variables, port = vgg_pair
    rng = np.random.RandomState(11)
    pred, target = (rng.rand(2, 32, 32, 3).astype(np.float32)
                    for _ in range(2))
    want = jm.apply(variables, jnp.asarray(pred))
    with torch.no_grad():
        got = port(_t(pred))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-4, f"tap {i}")

    def apply(v, x):
        return jm.apply(v, x)

    for name in ("perceptual_loss", "style_loss"):
        w = getattr(jperc, name)(apply, variables, jnp.asarray(pred),
                                 jnp.asarray(target))
        with torch.no_grad():
            g = getattr(tperc, name)(port, _t(pred), _t(target))
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4,
                                   err_msg=name)


def test_vgg19_loads_torchvision_feature_keys(vgg_pair):
    """A state dict with torchvision's ``features.<idx>`` names loads as
    it stands, and the JAX package's converter (which reads the same
    indices in conv order) gives back the mapping's leaves."""
    _, variables, port = vgg_pair
    state = {k: v.clone() for k, v in port.state_dict().items()}
    assert sorted(int(k.split(".")[1]) for k in state
                  if k.endswith(".weight")) == tperc.conv_indices()
    fresh = tperc.VGG19Features()
    fresh.load_state_dict(state)
    conv = jperc.convert_vgg19_checkpoint(
        {k[len("features."):]: v for k, v in state.items()}, variables)
    leaves = weights.torch_to_jax_leaves(fresh.state_dict(),
                                         weights.vgg19_mapping())
    for path, leaf in leaves.items():
        np.testing.assert_array_equal(
            np.asarray(conv[path[0]][path[1]][path[2]]), leaf)
