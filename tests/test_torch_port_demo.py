"""The port's quick-start demo (``python -m fgt_tpu_torch.tools.demo``)
against ``tools/demo.py``, on the CPU:

* the synthetic scene (12 frames at 240x432: 9x9 box-filtered noise, a
  green block and its dilated mask) equals ``tools/demo.py:synth_scene``'s
  PNGs byte for byte in every pixel (its cv2 ``filter2D`` is reproduced
  by ``overfit_gate.box_filter9``);
* a demo run at a tiny width (LAFC / FGT from tiny configs, random
  weights, 2 RAFT iterations, 64x112) writes the scene under
  ``<outroot>/scene`` and a 12-frame ``result.mp4`` that ``read_video``
  and cv2 read, holding ``result.npy``'s planes.
"""

import json
import os
import sys

import numpy as np
import torch

from fgt_tpu_torch.core import video_io
from fgt_tpu_torch.tools import demo
from test_torch_port_pipeline import TINY_FGT, TINY_LAFC

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_scene_equals_the_jax_demos(tmp_path):
    import imageio.v2 as imageio

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from demo import synth_scene
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    fdir, mdir = synth_scene(str(tmp_path / "jax"))
    frames, masks = demo.scene()
    assert frames.shape == (12, 240, 432, 3) and masks.shape == (12, 240, 432)
    for i in range(12):
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(fdir, f"{i:05d}.png")), frames[i])
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(mdir, f"{i:05d}.png")), masks[i])
    pdir, pmdir = demo.synth_scene(str(tmp_path / "port"))
    for i in range(12):
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(pdir, f"{i:05d}.png")), frames[i])
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(pmdir, f"{i:05d}.png")), masks[i])


def test_demo_writes_a_readable_result_mp4(tmp_path):
    import cv2

    for sub, cfg in (("lafc", TINY_LAFC),
                     ("fgt", dict(TINY_FGT, res_h=64, res_w=112))):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "config.json").write_text(json.dumps(cfg))
    out = tmp_path / "demo_out"
    path = demo.main([
        "--outroot", str(out), "--imgH", "64", "--imgW", "112",
        "--lafc_ckpts", str(tmp_path / "lafc"), "--fgt_ckpts",
        str(tmp_path / "fgt"), "--raft_model", "/nonexistent",
        "--device", "cpu", "--raft_iters", "2", "--f32"])
    assert path == os.path.join(str(out), "result.mp4")
    assert len(os.listdir(out / "scene" / "frames")) == 12
    frames = np.stack(video_io.read_video(path))
    result = np.load(out / "result.npy")
    assert frames.shape == result.shape == (12, 64, 112, 3)
    planes = video_io.read_planes(path)
    for frame, got in zip(result, planes):
        for a, b in zip(got, video_io.rgb_to_yuv420(frame)):
            np.testing.assert_array_equal(a, b)
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 12
