"""The port's watermark-removal and video-extrapolation modes against the
JAX package's ``video_inpainting --f32``, both through their CLIs, on
the CPU at 6 frames with 2 RAFT iterations and tiny LAFC/FGT; the same
weights move through ``convert.weights.jax_to_torch_state``.

Watermark removal runs from a source size that differs from the image
size, so it also pins the frame loader: premask at the source size, a
float cv2-INTER_LINEAR resize (reproduced bit for bit), RAFT on the
rounded flow-resolution frames resized on the host, and the gradient
stage's trunc through uint8. Outside the hole the two CLIs must then
write the same bytes.
"""

import jax
import numpy as np
import torch

from test_torch_port_pipeline import (TINY_FGT, TINY_LAFC, _video,
                                      run_jax_pipeline)
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.pipeline import video_inpainting as tvi

torch.set_num_threads(1)


def port_models(jm, corr="fused"):
    """The port's Models, f32 on the CPU, holding the JAX Models' weights."""
    np_vars = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    return tvi.Models(
        "cpu", bf16=False, raft_iters=2, lafc_config=TINY_LAFC,
        fgt_config=TINY_FGT, corr=corr,
        raft_state=weights.jax_to_torch_state(np_vars(jm.raft_vars),
                                              weights.raft_mapping()),
        lafc_state=weights.jax_to_torch_state(np_vars(jm.lafc_vars),
                                              weights.lafc_mapping(1)),
        fgt_state=weights.jax_to_torch_state(np_vars(jm.fgt_vars),
                                             weights.fgt_mapping(2)))


def run_port_cli(tmp_path, models, size, extra=()):
    """The port's CLI on the PNGs ``run_jax_pipeline`` wrote."""
    h, w = size
    args = tvi.build_parser().parse_args([
        "--path", str(tmp_path / "frames"), "--path_mask",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "port"),
        "--imgH", str(h), "--imgW", str(w), "--raft_iters", "2",
        "--flow_mask_dilates", "2", "--neighbor_stride", "3", "--step", "4",
        "--f32", "--device", "cpu", *extra])
    return np.load(tvi.video_inpainting(args, models=models))


def _close_inside(got, want, region):
    """Inside the hole the two agree up to f32 reassociation moving a
    value across an integer before a trunc-cast, or flipping one of
    flowNN's thresholded decisions: at most 1% of the pixels off by more
    than 1 level, mean |diff| <= 0.25."""
    d = np.abs(got.astype(int) - want.astype(int))[region]
    assert d.mean() <= 0.25 and (d > 1).mean() <= 0.01, (d.mean(), d.max())


def _from_another_source_size(tmp_path, mode, seed):
    """Source 72x80 -> image 64x64 through both CLIs."""
    frames, masks = _video(6, 72, 80, seed=seed)
    want, jm = run_jax_pipeline(tmp_path, frames, masks, size=(64, 64),
                                extra=("--mode", mode))
    got = run_port_cli(tmp_path, port_models(jm), (64, 64), ("--mode", mode))
    assert got.shape == want.shape == (6, 64, 64, 3)
    hole = tvi.load_masks(str(tmp_path / "masks"), 64, 64) > 0
    assert 0 < hole.mean() < 0.5
    np.testing.assert_array_equal(got[~hole], want[~hole])
    _close_inside(got, want, hole)


def test_object_removal_from_another_source_size(tmp_path):
    """The loader repair: before it, the port rounded the resized frames
    to u8 at load, and bytes outside the hole differed from the JAX
    CLI's, which keeps them float and truncates them in the gradient
    stage."""
    _from_another_source_size(tmp_path, "object_removal", 6)


def test_watermark_removal_from_another_source_size(tmp_path):
    """Frames premasked at the source size, before the resize."""
    _from_another_source_size(tmp_path, "watermark_removal", 7)


def test_video_extrapolation_matches_jax(tmp_path):
    """64x64 -> a 1.2x canvas of 76x76, s1 on the pyramid path (K3's plain
    version): the centre is the input in both, the border agrees."""
    frames, masks = _video(6, 64, 64, seed=8)
    extra = ("--mode", "video_extrapolation", "--H_scale", "1.2",
             "--W_scale", "1.2")
    want, jm = run_jax_pipeline(tmp_path, frames, masks, extra=extra)
    got = run_port_cli(tmp_path, port_models(jm, corr="pyramid"), (64, 64),
                       extra + ("--fused_corr", "off"))
    assert got.shape == want.shape == (6, 76, 76, 3)
    border = np.ones((6, 76, 76), bool)
    border[:, 6:70, 6:70] = False
    np.testing.assert_array_equal(got[:, 6:70, 6:70], frames)
    np.testing.assert_array_equal(want[:, 6:70, 6:70], frames)
    _close_inside(got, want, border)


def test_loader_resizes_like_cv2_and_keeps_floats(tmp_path):
    """``load_frames``: premask at the source size, then cv2's float
    INTER_LINEAR resize, no rounding; ``load_masks``: INTER_NEAREST."""
    import cv2

    from fgt_tpu_torch.pipeline import image_io

    frames, masks = _video(2, 50, 70, seed=9)
    for sub, arr in (("f", frames), ("m", masks * 255)):
        (tmp_path / sub).mkdir()
        for i, a in enumerate(arr):
            image_io.write_png(str(tmp_path / sub / f"{i:05d}.png"), a)
    got, src = tvi.load_frames(str(tmp_path / "f"), 64, 48,
                               str(tmp_path / "m"))
    assert src == (50, 70) and got.dtype == np.float32
    pre = frames.astype(np.float32) * (1 - masks[..., None])
    want = np.stack([cv2.resize(f, (48, 64), interpolation=cv2.INTER_LINEAR)
                     for f in pre])
    np.testing.assert_array_equal(got, want)
    assert (got != np.round(got)).any()
    m = tvi.load_masks(str(tmp_path / "m"), 64, 48)
    np.testing.assert_array_equal(m, np.stack([
        cv2.resize(a * 255, (48, 64), interpolation=cv2.INTER_NEAREST)
        for a in masks]))
