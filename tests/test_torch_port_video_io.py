"""``result.mp4`` of the port (``fgt_tpu_torch/core/video_io.py``: H.264,
every macroblock I_PCM, in an ISO-BMFF ``avc1`` track) on the CPU:

* cv2's FFMPEG build decodes it: every frame at its size, including
  sizes that need the SPS's cropping (854x480, 50x36) and a size that
  fits the macroblocks (432x240), at 30 fps;
* ``read_planes`` returns exactly the planes ``rgb_to_yuv420`` makes of
  the frames written, and ``read_video`` returns them as RGB within
  4 levels on average of cv2's decode (the two differ only in chroma
  upsampling and rounding);
* its PSNR against the source frames is no lower than that of the JAX
  package's ``write_video`` (here cv2's ``mp4v``) on the same frames,
  both decoded by cv2;
* an odd size is made even; a file of another codec, a frame of another
  size or dtype raises;
* the inference CLI and the batch driver write one ``result.mp4`` a
  video, holding ``result.npy``'s planes.
"""

import json

import numpy as np
import pytest
import scipy.ndimage
import torch

from fgt_tpu.core import video_io as jvideo_io
from fgt_tpu_torch.core import video_io
from test_torch_port_pipeline import TINY_FGT, TINY_LAFC, _video

torch.set_num_threads(1)


def _clip(n, h, w, size=9, seed=0):
    """Box-filtered noise panning 2 px a frame."""
    rng = np.random.RandomState(seed)
    base = scipy.ndimage.uniform_filter(rng.rand(h, w + 2 * n, 3) * 255,
                                        size=(size, size, 1))
    return np.stack([base[:, 2 * i:2 * i + w]
                     for i in range(n)]).astype(np.uint8)


def _cv2_frames(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = []
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        frames.append(fr[:, :, ::-1])
    cap.release()
    return np.stack(frames), fps


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean(
        (a.astype(np.float64) - b.astype(np.float64)) ** 2))


@pytest.mark.parametrize("n,h,w", [(5, 240, 432), (3, 480, 854),
                                   (4, 36, 50), (2, 16, 16)])
def test_cv2_decodes_and_planes_round_trip(n, h, w, tmp_path):
    frames = _clip(n, h, w)
    path = tmp_path / "v.mp4"
    video_io.write_video(str(path), frames)
    decoded, fps = _cv2_frames(path)
    assert decoded.shape == (n, h, w, 3) and fps == 30.0
    planes = video_io.read_planes(str(path))
    assert len(planes) == n
    for frame, got in zip(frames, planes):
        want = video_io.rgb_to_yuv420(frame)
        assert [p.shape for p in got] == [(h, w), (h // 2, w // 2),
                                          (h // 2, w // 2)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    rgb = np.stack(video_io.read_video(str(path)))
    assert rgb.shape == frames.shape and rgb.dtype == np.uint8
    assert np.abs(rgb.astype(int) - decoded).mean() <= 4.0


@pytest.mark.parametrize("size", [5, 9])
def test_psnr_no_lower_than_the_jax_writer(size, tmp_path):
    """24 frames at 240x432 of box-filtered noise (5x5: much chroma
    detail; 9x9: the demo's texture), both files decoded by cv2."""
    frames = _clip(24, 240, 432, size=size, seed=size)
    video_io.write_video(str(tmp_path / "port.mp4"), frames)
    jvideo_io.write_video(str(tmp_path / "jax.mp4"), list(frames))
    port, _ = _cv2_frames(tmp_path / "port.mp4")
    jax_out, _ = _cv2_frames(tmp_path / "jax.mp4")
    assert port.shape == jax_out.shape == frames.shape
    assert _psnr(port, frames) >= _psnr(jax_out, frames)
    assert _psnr(np.stack(video_io.read_video(str(tmp_path / "port.mp4"))),
                 frames) >= _psnr(jax_out, frames)


def test_odd_sizes_other_codecs_and_bad_frames(tmp_path):
    frames = _clip(3, 35, 49)
    video_io.write_video(str(tmp_path / "odd.mp4"), frames)
    decoded, _ = _cv2_frames(tmp_path / "odd.mp4")
    assert decoded.shape == (3, 36, 50, 3)
    y = video_io.read_planes(str(tmp_path / "odd.mp4"))[0][0]
    np.testing.assert_array_equal(y[:, -1], y[:, -2])       # repeated
    jvideo_io.write_video(str(tmp_path / "mp4v.mp4"), list(_clip(2, 32, 32)))
    with pytest.raises(ValueError, match="mp4v.mp4"):
        video_io.read_video(str(tmp_path / "mp4v.mp4"))
    with pytest.raises(ValueError, match="uint8"):
        video_io.write_video(str(tmp_path / "f.mp4"),
                             frames.astype(np.float32))
    with pytest.raises(ValueError, match="every frame"):
        video_io.write_video(str(tmp_path / "f.mp4"),
                             [frames[0], frames[1, :34]])


def test_cli_and_batch_write_result_mp4(tmp_path):
    """Two 4-frame videos at 32x32 through the batch driver (tiny models,
    random weights, f32): each output directory holds a ``result.mp4``
    whose planes are those of its ``result.npy``."""
    from fgt_tpu_torch.pipeline import batch, image_io

    for v in range(2):
        frames, masks = _video(4, 32, 32, seed=20 + v)
        for sub, stack in (("frames", frames), ("masks", masks * 255)):
            d = tmp_path / sub / f"video{v}"
            d.mkdir(parents=True)
            for i, img in enumerate(stack):
                image_io.write_png(str(d / f"{i:05d}.png"), img)
    for sub, cfg in (("lafc", TINY_LAFC), ("fgt", dict(TINY_FGT, res_h=32,
                                                       res_w=32))):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "config.json").write_text(json.dumps(cfg))
    batch.main([
        "--videos_root", str(tmp_path / "frames"), "--masks_root",
        str(tmp_path / "masks"), "--outroot", str(tmp_path / "out"),
        "--lafc_ckpts", str(tmp_path / "lafc"), "--fgt_ckpts",
        str(tmp_path / "fgt"), "--raft_model", "/nonexistent", "--imgH",
        "32", "--imgW", "32", "--raft_iters", "1", "--flow_mask_dilates",
        "1", "--neighbor_stride", "2", "--step", "2", "--f32", "--device",
        "cpu"])
    for v in range(2):
        out = tmp_path / "out" / f"video{v}"
        result = np.load(out / "result.npy")
        planes = video_io.read_planes(str(out / "result.mp4"))
        assert len(planes) == len(result) == 4
        for frame, got in zip(result, planes):
            for a, b in zip(got, video_io.rgb_to_yuv420(frame)):
                np.testing.assert_array_equal(a, b)
        decoded, _ = _cv2_frames(out / "result.mp4")
        assert decoded.shape == result.shape
