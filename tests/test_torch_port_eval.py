"""The port's evaluation stack against the JAX package's, on the CPU:

* flow colouring (``flow_to_rgb`` / ``flow_to_image``): byte-equal;
* PSNR, SSIM, the MATLAB-style SSIM (scipy's correlate against the JAX
  function's ``cv2.filter2D``), the batch frame and flow metrics: within
  1e-9 relative;
* I3D: the port's module, loaded from a pytorch-i3d-named state dict,
  against the JAX ``I3D`` through ``convert_i3d_checkpoint``, at an odd
  clip size; the weight table's direction from JAX to the port;
* the Fréchet distance and ``VFIDScorer``'s clip cut (tail clip, tiled
  short videos): equal;
* ``resize_linear_u8`` bit-equal to ``cv2.resize`` on uint8;
* the evaluation driver on a two-video PNG tree with tiny checkpoints:
  its per-video numbers equal ``fgt_tpu.core.metrics`` on its own
  ``result.npy`` and the cv2-resized ground truth.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.core import flow_viz as jviz
from fgt_tpu.core import metrics as jmetrics
from fgt_tpu.core import vfid as jvfid
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.core import flow_viz as tviz
from fgt_tpu_torch.core import metrics as tmetrics
from fgt_tpu_torch.core import vfid as tvfid
from fgt_tpu_torch.pipeline import evaluate, image_io
from test_torch_port_pipeline import TINY_FGT, TINY_LAFC

torch.set_num_threads(1)


def _flow(seed, h=24, w=40, scale=6.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(h, w, 2) * scale).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "zero", "unknown_nan", "rad_max"])
def test_flow_colouring_byte_equal(case):
    flow = _flow(0)
    rad_max = None
    if case == "zero":
        flow[:] = 0
    elif case == "unknown_nan":
        flow[0, :5] = 1e10                   # flow_to_rgb's "unknown"
        flow[1, :3, 1] = np.nan
    elif case == "rad_max":
        rad_max = 3.0                       # saturates the wheel
    np.testing.assert_array_equal(tviz.flow_to_rgb(flow),
                                  jviz.flow_to_rgb(flow))
    got = tviz.flow_to_image(flow, rad_max)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jviz.flow_to_image(flow, rad_max))


def _frames(seed, b=3, h=37, w=45, noise=12):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    res = np.clip(gt.astype(int) + rng.randint(-noise, noise + 1, gt.shape),
                  0, 255).astype(np.uint8)
    return res, gt


def _close(a, b):
    assert abs(a - b) <= 1e-9 * max(abs(b), 1e-12), (a, b)


@pytest.mark.parametrize("fn", ["psnr", "ssim", "ssim_single",
                                "ssim_matlab"])
def test_image_metrics_match_jax(fn):
    """Within 1e-9 relative: the same float64 arithmetic, except
    ssim_matlab's filter (scipy's correlate against cv2.filter2D, which
    may sum in another order or through a DFT)."""
    res, gt = _frames(1)
    if fn == "psnr":
        args = [(res[0], gt[0]), (res[0].astype(np.float32) / 255,
                                  gt[0].astype(np.float32) / 255)]
    elif fn == "ssim":
        args = [(res[0], gt[0]), (res[1, ..., 0], gt[1, ..., 0])]
    else:
        args = [(res[0, ..., 0], gt[0, ..., 0]), (res[2, ..., 1],
                                                  gt[2, ..., 1])]
    for a, b in args:
        _close(getattr(tmetrics, fn)(a, b), getattr(jmetrics, fn)(a, b))


def test_batch_metrics_match_jax():
    res, gt = _frames(2)
    got = tmetrics.calculate_metrics(res, gt)
    want = jmetrics.calculate_metrics(res, gt)
    assert set(got) == set(want) == {"l1", "l2", "psnr", "ssim"}
    for k in want:
        _close(got[k], want[k])
    flows = np.stack([_flow(s) for s in range(3)])
    noisy = flows + np.random.RandomState(4).randn(*flows.shape).astype(
        np.float32) * 0.3
    got = tmetrics.calculate_flow_metrics(noisy, flows)
    want = jmetrics.calculate_flow_metrics(noisy, flows)
    for k in want:
        _close(got[k], want[k])


def _i3d_state(seed=0):
    """A random pytorch-i3d-named state dict (conv3d weights of fan-in
    scale, non-identity batch norms) plus the classifier and BN counters
    a real ``rgb_imagenet.pt`` carries."""
    rng = np.random.RandomState(seed)
    state = {}
    for k, v in tvfid.I3D().state_dict().items():
        if k.endswith("conv3d.weight"):
            a = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith(("running_var", "bn.weight")):
            a = 0.5 + rng.rand(*v.shape)
        else:
            a = 0.1 * rng.randn(*v.shape)
        state[k] = torch.from_numpy(a.astype(np.float32))
    state["logits.conv3d.weight"] = torch.zeros(400, 1024, 1, 1, 1)
    state["logits.conv3d.bias"] = torch.zeros(400)
    state["Conv3d_1a_7x7.bn.num_batches_tracked"] = torch.tensor(0)
    return state


@pytest.fixture(scope="module")
def i3d_pair():
    """One JAX I3D (its CPU compile is the slow part) and the port's,
    from the same state dict."""
    clip = np.random.RandomState(5).uniform(-1, 1, (1, 9, 33, 33, 3)).astype(
        np.float32)
    state = _i3d_state()
    model = jvfid.I3D()
    template = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(clip))
    variables = jvfid.convert_i3d_checkpoint(
        {k: v for k, v in state.items() if not k.startswith("logits")},
        template)
    apply = jax.jit(model.apply)
    port = tvfid.load_i3d_state(tvfid.I3D(), state).eval()
    return apply, variables, port, state, clip


def test_i3d_matches_jax(i3d_pair):
    """[1, 9, 33, 33, 3] clip (odd sizes: the (0, 1)-padded stride-2
    pools pad), f32 features within 1e-4 of the largest |feature|
    (convolution reassociation over 57 layers)."""
    apply, variables, port, _, clip = i3d_pair
    want = np.asarray(apply(variables, jnp.asarray(clip)))
    with torch.no_grad():
        got = port(torch.from_numpy(clip)).numpy()
    assert got.shape == want.shape == (1, 1024)
    top = np.abs(want).max()
    assert top > 0 and np.abs(got - want).max() <= 1e-4 * top


def test_i3d_weight_table_moves_jax_variables_to_the_port(i3d_pair):
    """JAX I3D variables -> the port's state dict through
    ``weights.i3d_mapping``: every key the port has, each tensor the one
    the state dict gave ``convert_i3d_checkpoint``."""
    _, variables, port, state, _ = i3d_pair
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    bridged = weights.jax_to_torch_state(np_vars, weights.i3d_mapping())
    assert set(bridged) == set(port.state_dict())
    for k, v in bridged.items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy())


def test_frechet_distance_matches_jax():
    rng = np.random.RandomState(6)
    a = rng.randn(40, 12)
    b = rng.randn(40, 12) * 1.3 + 0.5
    stats = [tvfid.feature_stats(a), tvfid.feature_stats(b)]
    for got, want in zip(stats, [jvfid.feature_stats(a),
                                 jvfid.feature_stats(b)]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    _close(tvfid.frechet_distance(*stats[0], *stats[1]),
           jvfid.frechet_distance(*stats[0], *stats[1]))
    _close(tvfid.frechet_distance(*stats[0], *stats[0]),
           jvfid.frechet_distance(*stats[0], *stats[0]))


def _clip_features(clips: np.ndarray) -> np.ndarray:
    """A stand-in trunk that keeps each clip's frame order and position:
    [n, T, H, W, 3] -> [n, 2T] (per-frame means, per-frame first pixel)."""
    c = np.asarray(clips, np.float32)
    return np.concatenate([c.mean(axis=(2, 3, 4)), c[:, :, 0, 0, 0]], 1)


@pytest.mark.parametrize("lengths", [(5, 7), (16, 16), (20, 23), (35, 40)])
def test_vfid_scorer_clip_cut_matches_jax(lengths):
    """Short videos tiled (5, 7 frames), whole clips (16), a tail clip
    ending at the last frame (20, 23, 35, 40): the same clips reach the
    trunk in both scorers, so with one stand-in trunk the scores are
    equal."""
    rng = np.random.RandomState(sum(lengths))
    real = [rng.randint(0, 256, (t, 8, 8, 3)).astype(np.uint8)
            for t in lengths]
    fake = [np.clip(v.astype(int) + rng.randint(-30, 31, v.shape), 0, 255)
            .astype(np.uint8) for v in real]
    jscorer = jvfid.VFIDScorer.__new__(jvfid.VFIDScorer)
    jscorer.clip_len, jscorer.variables = 16, None
    jscorer.real, jscorer.fake = [], []
    jscorer._fn = lambda v, x: _clip_features(x)
    tscorer = tvfid.VFIDScorer(clip_len=16, device="cpu")
    tscorer.model = lambda x: torch.from_numpy(_clip_features(x.numpy()))
    for r, f in zip(real, fake):
        jscorer.update(r, f)
        tscorer.update(r, f)
    for got, want in zip(tscorer.real + tscorer.fake,
                         jscorer.real + jscorer.fake):
        np.testing.assert_array_equal(got, want)
    _close(tscorer.score(), jscorer.score())


@pytest.mark.parametrize("src,dst", [
    ((72, 80), (64, 64)),      # the driver test's downscale
    ((64, 64), (240, 432)),    # upscale
    ((480, 854), (240, 432)),  # DAVIS 480p to the benchmark size
    ((37, 53), (61, 29))])     # up in one axis, down in the other
def test_resize_linear_u8_bit_equal_to_cv2(src, dst):
    """cv2's uint8 INTER_LINEAR is fixed point (11-bit weights, its
    vector path's rounding); the twin must give the same bytes, RGB and
    gray."""
    rng = np.random.RandomState(src[0] + dst[1])
    for shape in (src + (3,), src):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        want = cv2.resize(img, dst[::-1])
        got = image_io.resize_linear_u8(img, *dst)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # the float path differs from it: the u8 twin is not resize_linear
    img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    flt = image_io.resize_linear(img[None], *dst)[0]
    assert not np.array_equal(np.round(flt).astype(np.uint8),
                              cv2.resize(img, dst[::-1]))


def _tree(root, videos=2, n=6, h=72, w=80):
    """Two PNG videos of panning smoothed noise with a moving hole, at a
    source size the driver resizes from."""
    rng = np.random.RandomState(7)
    for v in range(videos):
        fdir, mdir = root / "frames" / f"video{v}", root / "masks" / f"video{v}"
        fdir.mkdir(parents=True)
        mdir.mkdir(parents=True)
        base = (rng.rand(h, w + 2 * n, 3) * 255).astype(np.float32)
        base = cv2.blur(base, (5, 5)).astype(np.uint8)
        for i in range(n):
            image_io.write_png(str(fdir / f"{i:05d}.png"),
                               base[:, 2 * i:2 * i + w])
            m = np.zeros((h, w), np.uint8)
            m[24:44, 20 + 2 * i:40 + 2 * i] = 255
            image_io.write_png(str(mdir / f"{i:05d}.png"), m)
    for sub, cfg in (("lafc", TINY_LAFC), ("fgt", TINY_FGT)):
        (root / sub).mkdir()
        with open(root / sub / "config.json", "w") as f:
            json.dump(cfg, f)
    return root


def test_evaluate_driver_matches_jax_metrics(tmp_path):
    """The driver on two 6-frame PNG videos at 72x80, inpainted at 64x64
    (tiny LAFC/FGT, 2 RAFT iterations, random weights) with a random I3D
    state dict: each video's PSNR, SSIM, L1 and L2 equal (1e-9 relative)
    the JAX package's metrics on the driver's ``result.npy`` and the
    frames resized by ``cv2.resize``; VFID finite; ``eval.json``
    written."""
    import imageio.v2 as imageio

    root = _tree(tmp_path)
    torch.save(_i3d_state(1), tmp_path / "i3d.pt")
    out = tmp_path / "out"
    summary = evaluate.main([
        "--frames", str(root / "frames"), "--masks", str(root / "masks"),
        "--outroot", str(out), "--imgH", "64", "--imgW", "64",
        "--lafc_ckpts", str(root / "lafc"), "--fgt_ckpts", str(root / "fgt"),
        "--raft_model", "/nonexistent", "--raft_iters", "2",
        "--vfid_ckpt", str(tmp_path / "i3d.pt"), "--device", "cpu"])
    assert summary["num_videos"] == 2 and summary["frames"] == 12
    for video in ("video0", "video1"):
        result = np.load(out / video / "result.npy")
        files = sorted(os.listdir(root / "frames" / video))
        gt = np.stack([cv2.resize(imageio.imread(
            root / "frames" / video / f)[..., :3], (64, 64)) for f in files])
        assert result.shape == gt.shape == (6, 64, 64, 3)
        diff = result.astype(np.float64) - gt.astype(np.float64)
        want = {"psnr": np.mean([jmetrics.psnr(r, g)
                                 for r, g in zip(result, gt)]),
                "ssim": np.mean([jmetrics.ssim(r, g)
                                 for r, g in zip(result, gt)]),
                "l1": np.abs(diff).mean(), "l2": (diff ** 2).mean()}
        for k, w in want.items():
            _close(summary["per_video"][video][k], float(w))
        assert 10.0 < want["psnr"] < 60.0      # resembles the GT, not equal
    assert np.isfinite(summary["vfid"])
    with open(out / "eval.json") as f:
        saved = json.load(f)
    assert saved["psnr"] == summary["psnr"] and saved["vfid"] == \
        summary["vfid"]
