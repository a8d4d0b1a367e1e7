"""Stages of the port's object-removal driver and the whole slice against
the JAX package's driver, on the CPU, in f32:

* s1: ``calculate_flows`` vs the JAX pipeline's encode + refine programs
  (``Models.raft_encode_fn`` / ``Models.raft_scan``);
* s4-s5: gradients, flowNN propagation and Poisson blending vs the JAX
  driver's ``prepare_gradients`` (with its cv2 TELEA seed),
  ``get_flownn_gradient_frames`` and ``poisson_blend``;
* the whole slice: ``inpaint`` vs ``video_inpainting --f32`` on 6 frames
  at 64x64 with 2 RAFT iterations and tiny LAFC/FGT (about a minute with
  a cold JAX compile cache: the JAX pipeline compiles every stage).
Weights move through ``convert.weights.jax_to_torch_state``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from fgt_tpu.models.raft import RAFT, RAFTConfig
from fgt_tpu.pipeline import poisson as jpoisson
from fgt_tpu.pipeline import propagation as jprop
from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import raft as traft
from fgt_tpu_torch.pipeline import poisson as tpoisson
from fgt_tpu_torch.pipeline import propagation as tprop
from fgt_tpu_torch.pipeline import video_inpainting as tvi

torch.set_num_threads(1)


def _video(n, h, w, seed=0):
    """Smoothed noise panning 2 px/frame with a moving square hole."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h, w + 2 * n, 3).astype(np.float32) * 255
    base = scipy.ndimage.uniform_filter(base, size=(5, 5, 1)).astype(np.uint8)
    frames = np.stack([base[:, 2 * i:2 * i + w] for i in range(n)])
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        masks[i, h * 3 // 8:h * 5 // 8, w // 4 + i:w // 4 + i + h // 4] = 1
    return frames, masks


def test_s1_flows_match_jax_driver_programs():
    """6 frames at 32x32 (flows at 64x64 by the 2x rule), both
    directions, 2 GRU iterations. f32; tolerance 2e-3 px at image
    resolution: K1's plain version reassociates the correlation."""
    n, h, w = 6, 32, 32
    frames, _ = _video(n, h, w)
    model = RAFT(RAFTConfig(iters=2))
    dummy = jnp.zeros((1, 64, 64, 3))
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, iters=1))(
        jax.random.PRNGKey(0), dummy, dummy)
    jm = jvi.Models.__new__(jvi.Models)
    jm.raft, jm.raft_vars, jm.raft_cfg = model, variables, model.cfg
    jm.dtype, jm.wire = jnp.float32, jnp.float32
    jm._jit_cache, jm._variant_cache = {}, {}
    fmap, net, inp = jm.raft_encode_fn(variables, jnp.asarray(frames), 64, 64,
                                       jvi.RAFT_ENCODE_CHUNK)
    pairs = n - 1
    src = np.concatenate([np.arange(pairs), np.arange(1, n)])
    dst = np.concatenate([np.arange(1, n), np.arange(pairs)])
    idx = np.stack([src, dst])[None].astype(np.int32)       # [1, 2, B]
    want = np.asarray(jm.raft_scan("xla")(variables, fmap, net, inp,
                                          jnp.asarray(idx), 2, h, w))

    models = tvi.Models.__new__(tvi.Models)
    models.raft = traft.RAFT().eval()
    weights.load_state(models.raft, weights.jax_to_torch_state(
        jax.tree_util.tree_map(np.asarray, variables),
        weights.raft_mapping()))
    models.dtype, models.raft_iters = torch.float32, 2
    models.corr, models.corr_dtype = "fused", torch.float32
    with torch.no_grad():
        ff, fb = tvi.calculate_flows(models, torch.from_numpy(frames), 64, 64,
                                     chunk=4)
    np.testing.assert_allclose(ff.numpy(), want[:pairs], atol=2e-3)
    np.testing.assert_allclose(fb.numpy(), want[pairs:], atol=2e-3)


def test_s45_gradients_flownn_poisson_match_jax():
    """Same completed flows in: the port (no TELEA seed) and the JAX
    driver (TELEA seed) give identical gradients, propagation and
    Poisson blends wherever Poisson reached; only pixels left unfilled
    for FGT (identical masks) may differ, and FGT never reads them."""
    n, h, w = 6, 48, 64
    frames, holes = _video(n, h, w, seed=1)
    mask = holes > 0
    dil = np.stack([jvi.gradient_mask(m) for m in mask])
    rng = np.random.RandomState(2)
    flow = scipy.ndimage.uniform_filter(
        rng.randn(n - 1, h, w, 2).astype(np.float32) * 2, size=(1, 9, 9, 1))
    flow_f = (flow + np.float32([2.0, 0.0])).astype(np.float32)
    flow_b = (-flow_f + 0.05 * rng.randn(*flow.shape)).astype(np.float32)
    video = frames.astype(np.float32) / 255.0

    def run(prep, prop, pois, cfg):
        vid, gx, gy = prep(video, mask, dil)
        gx, gy, tofill = prop(cfg(5.0, 0.1), gx, gy, mask, flow_f, flow_b)
        tofill = np.stack([scipy.ndimage.binary_fill_holes(m) for m in tofill])
        blends, left = [], mask.copy()
        for i in range(n):
            b, left[i] = pois(vid[i], gx[i][:, :w - 1], gy[i][:h - 1],
                              mask[i], tofill[i])
            blends.append(np.clip(b, 0, 1))
        return np.stack(blends), left, gx, gy

    jb, jleft, jgx, jgy = run(jvi.prepare_gradients,
                              jprop.get_flownn_gradient_frames,
                              jpoisson.poisson_blend, jprop.PropagationConfig)
    tb, tleft, tgx, tgy = run(tvi.prepare_gradients,
                              tprop.get_flownn_gradient_frames,
                              tpoisson.poisson_blend, tprop.PropagationConfig)
    np.testing.assert_array_equal(tgx, jgx)
    np.testing.assert_array_equal(tgy, jgy)
    np.testing.assert_array_equal(tleft, jleft)
    assert mask.sum() > tleft.sum() > 0    # Poisson filled some, not all
    np.testing.assert_allclose(tb[~tleft], jb[~tleft], atol=1e-9)


TINY_LAFC = {"model": "lafc", "num_flows": 3, "flow_interval": 3, "cnum": 8,
             "in_channel": 3, "PASSMASK": 1, "use_residual": 1,
             "resBlocks": 1, "use_bias": 1, "conv_type": "vanilla",
             "use_edges": 0}
TINY_FGT = {
    "model": "model", "in_channel": 4, "cnum": 8, "flow_inChannel": 2,
    "flow_cnum": 8, "frame_hidden": 32, "flow_hidden": 16, "PASSMASK": 1,
    "numBlocks": 2, "num_head": 4, "conv_type": "vanilla", "norm": None,
    "use_bias": 1, "ape": 1, "mlp_ratio": 2, "drop": 0, "tw": 2, "sw": 4,
    "gd": 2, "kernel_size_w": 7, "kernel_size_h": 7, "stride_h": 3,
    "stride_w": 3, "pad_h": 3, "pad_w": 3, "res_h": 64, "res_w": 64,
}


def run_jax_pipeline(tmp_path, frames, masks, extra=(), size=None):
    """JAX ``video_inpainting --f32`` on PNG inputs (written under
    ``tmp_path``/frames and /masks), at ``size`` (default the frames'),
    with ``extra`` flags; returns (output frames from the --vis_frame
    PNGs, the JAX Models)."""
    import imageio.v2 as imageio
    import yaml

    for sub in ("frames", "masks", "lafc", "fgt"):
        (tmp_path / sub).mkdir()
    for i, (fr, m) in enumerate(zip(frames, masks)):
        imageio.imwrite(tmp_path / "frames" / f"{i:05d}.png", fr)
        imageio.imwrite(tmp_path / "masks" / f"{i:05d}.png", m * 255)
    for sub, cfg in (("lafc", TINY_LAFC), ("fgt", TINY_FGT)):
        with open(tmp_path / sub / "config.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
    n = frames.shape[0]
    h, w = size or frames.shape[1:3]
    args = jvi.build_parser().parse_args([
        "--path", str(tmp_path / "frames"), "--path_mask",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "out"),
        "--lafc_ckpts", str(tmp_path / "lafc"), "--fgt_ckpts",
        str(tmp_path / "fgt"), "--raft_model", "/nonexistent",
        "--imgH", str(h), "--imgW", str(w), "--raft_iters", "2",
        "--flow_mask_dilates", "2", "--neighbor_stride", "3", "--step", "4",
        "--f32", "--vis_frame", *extra])
    models = jvi.Models(args)
    jvi.video_inpainting(args, models=models)
    out = np.stack([imageio.imread(tmp_path / "out" / "frames" /
                                   f"{i:05d}.png") for i in range(n)])
    return out, models


def test_whole_slice_matches_jax_pipeline(tmp_path):
    """Outside the hole the output bytes equal the input in both. Inside,
    the two agree byte for byte on this input; the bound leaves room for
    f32 reassociation (K1's corner dots, conv order) to move a value
    across an integer before a trunc-cast, or to flip one of flowNN's
    thresholded decisions for a few pixels: at most 1% of hole pixels
    off by more than 1 level, mean |diff| <= 0.25."""
    frames, masks = _video(6, 64, 64, seed=3)
    want, jm = run_jax_pipeline(tmp_path, frames, masks)
    np_vars = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    models = tvi.Models(
        "cpu", bf16=False, raft_iters=2, lafc_config=TINY_LAFC,
        fgt_config=TINY_FGT,
        raft_state=weights.jax_to_torch_state(np_vars(jm.raft_vars),
                                              weights.raft_mapping()),
        lafc_state=weights.jax_to_torch_state(np_vars(jm.lafc_vars),
                                              weights.lafc_mapping(1)),
        fgt_state=weights.jax_to_torch_state(np_vars(jm.fgt_vars),
                                             weights.fgt_mapping(2)))
    got = tvi.inpaint(frames, masks, models, flow_mask_dilates=2,
                      neighbor_stride=3, step=4)
    hole = masks > 0
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    np.testing.assert_array_equal(want[~hole], frames[~hole])
    d = np.abs(got.astype(int) - want.astype(int))[hole]
    assert d.mean() <= 0.25 and (d > 1).mean() <= 0.01, (d.mean(), d.max())


def test_cli_reads_pngs_and_writes_npy_and_pngs(tmp_path):
    """The port's CLI end to end on the CPU at a tiny size: PNG stacks
    in (stdlib reader), a reference-keyed FGT state dict loaded from its
    checkpoint directory, result.npy + PNGs out, unchanged outside the
    hole."""
    import json

    from fgt_tpu_torch.models import fgt as tfgt
    from fgt_tpu_torch.pipeline import image_io

    frames, masks = _video(4, 32, 32, seed=4)
    for sub in ("frames", "masks", "lafc", "fgt"):
        (tmp_path / sub).mkdir()
    for i, (fr, m) in enumerate(zip(frames, masks)):
        image_io.write_png(str(tmp_path / "frames" / f"{i:05d}.png"), fr)
        image_io.write_png(str(tmp_path / "masks" / f"{i:05d}.png"), m * 255)
    for sub, cfg in (("lafc", TINY_LAFC), ("fgt", TINY_FGT)):
        with open(tmp_path / sub / "config.json", "w") as f:
            json.dump(cfg, f)
    torch.save({"model_state_dict": {
        "module." + k: v for k, v in tfgt.Model(TINY_FGT).state_dict().items()}},
        tmp_path / "fgt" / "fgt.pth")
    out_path = tvi.main([
        "--path", str(tmp_path / "frames"), "--path_mask",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "out"),
        "--lafc_ckpts", str(tmp_path / "lafc"), "--fgt_ckpts",
        str(tmp_path / "fgt"), "--raft_model", "/nonexistent",
        "--imgH", "32", "--imgW", "32", "--raft_iters", "1",
        "--flow_mask_dilates", "1", "--neighbor_stride", "2", "--step", "2",
        "--f32", "--device", "cpu"])
    out = np.load(out_path)
    assert out.shape == frames.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out[masks == 0], frames[masks == 0])
    png = image_io.read_png(os.path.join(str(tmp_path / "out"), "frames",
                                         "00003.png"))
    np.testing.assert_array_equal(png, out[3])
