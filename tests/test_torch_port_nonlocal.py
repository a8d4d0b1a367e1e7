"""``--Nonlocal`` in the port against the JAX package, on the CPU, f32:

* the reference-layout propagation ``get_flownn_gradient`` with the
  key-frame candidates against ``fgt_tpu.pipeline.propagation``, and its
  ``interp``/``consist_check`` against the cv2.remap-based originals;
* the whole pipeline with ``--Nonlocal`` (key-frame flows on the
  all-pairs pyramid path, K3's plain version) against the JAX CLI's
  ``video_inpainting --f32 --Nonlocal`` at 6x64x64.
"""

import numpy as np
import scipy.ndimage
import torch

from test_torch_port_modes import _close_inside, port_models
from test_torch_port_pipeline import _video, run_jax_pipeline
from fgt_tpu.pipeline import propagation as jprop
from fgt_tpu_torch.ops import corr_lookup as tcl
from fgt_tpu_torch.pipeline import propagation as tprop
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from torch_port_jax_native import require_jax_native

torch.set_num_threads(1)


def test_interp_and_consist_check_match_cv2_remap():
    """Bit-exact against cv2.remap (INTER_LINEAR, zero border) on 1 and
    3 channels, coords inside, on and far outside the image."""
    rng = np.random.RandomState(0)
    img = (rng.randn(37, 45, 3) * 3).astype(np.float32)
    x = (rng.rand(5000) * 55 - 5).astype(np.float32)
    y = (rng.rand(5000) * 47 - 5).astype(np.float32)
    x[:10], y[10:20], x[20:30] = 1e7, -1e6, 44.0
    for im in (img, img[:, :, 0]):
        np.testing.assert_array_equal(tprop.interp(im, x, y),
                                      jprop.interp(im, x, y))
    ff = (rng.randn(37, 45, 2) * 3).astype(np.float32)
    fb = (rng.randn(37, 45, 2) * 3).astype(np.float32)
    for a, b in zip(tprop.consist_check(ff, fb), jprop.consist_check(ff, fb)):
        np.testing.assert_array_equal(a, b)


def test_nonlocal_propagation_matches_jax():
    """Same gradients, masks, local and key-frame flows in: the port's
    native passes + key-frame fusion equal the JAX package's
    ``get_flownn_gradient`` with nonlocal flows, bit for bit (the JAX
    side on its native path, waited for past the in-place build race)."""
    require_jax_native()
    rng = np.random.RandomState(1)
    h, w, n, c = 24, 32, 5, 3
    mask = np.zeros((h, w, n), bool)
    for t in range(n):
        mask[8:16, 6 + 2 * t:16 + 2 * t, t] = True
    smooth = lambda a: scipy.ndimage.uniform_filter(  # noqa: E731
        a, size=(7, 7) + (1,) * (a.ndim - 2)).astype(np.float32)
    ff = smooth(rng.randn(h, w, 2, n - 1) * 2 + np.float32(1.5)
                * np.eye(2, dtype=np.float32)[0][None, None, :, None])
    fb = (-ff + 0.05 * rng.randn(*ff.shape)).astype(np.float32)
    nl_f = smooth(rng.randn(h, w, 2, 3, n) * 3)
    nl_b = (-nl_f + 0.05 * rng.randn(*nl_f.shape)).astype(np.float32)
    gx = rng.randn(h, w, c, n).astype(np.float32)
    gy = rng.randn(h, w, c, n).astype(np.float32)
    cfg = (5.0, 0.1)
    want = jprop.get_flownn_gradient(
        jprop.PropagationConfig(*cfg), gx, gy, mask, mask, ff, fb,
        nonlocal_flow_f=nl_f, nonlocal_flow_b=nl_b)
    got = tprop.get_flownn_gradient(tprop.PropagationConfig(*cfg), gx, gy,
                                    mask, ff, fb, nl_f, nl_b)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g, wnt)
    assert mask.sum() > want[2].sum()          # some hole pixels filled


def test_nonlocal_pipeline_matches_jax(tmp_path):
    """6 frames at 64x64, --Nonlocal (keys 0, 3, 5): outside the hole the
    input in both, inside within the whole-slice bound; the port's
    key-frame flows ran on the pyramid path."""
    frames, masks = _video(6, 64, 64, seed=10)
    want, jm = run_jax_pipeline(tmp_path, frames, masks,
                                extra=("--Nonlocal", "1"))
    models = port_models(jm, corr="pyramid")
    args = tvi.build_parser().parse_args([
        "--path", str(tmp_path / "frames"), "--path_mask",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "port"),
        "--imgH", "64", "--imgW", "64", "--raft_iters", "2",
        "--flow_mask_dilates", "2", "--neighbor_stride", "3", "--step", "4",
        "--f32", "--device", "cpu", "--Nonlocal", "1", "--fused_corr",
        "off"])
    assert args.Nonlocal is True
    got = np.load(tvi.video_inpainting(args, models=models))
    hole = masks > 0
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    np.testing.assert_array_equal(want[~hole], frames[~hole])
    _close_inside(got, want, hole)
    assert tcl.lookup_corr_pyramid.launches == 0    # CPU: plain version
