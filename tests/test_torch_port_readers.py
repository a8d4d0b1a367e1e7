"""The port's dataset-preparation readers (``fgt_tpu_torch.data.readers``)
and image reader modes (``pipeline.image_io.imread``) against the JAX
package's ``fgt_tpu.data.readers``, cv2 and imageio, on the CPU:

* every reader over the same folders gives the JAX reader's arrays:
  RGB, RGBA, gray, palette, 16-bit and Adam7-interlaced PNG, baseline,
  progressive, CMYK and EXIF-rotated JPEG; resize, scale, sampling
  period and max length; masks' boxes in cv2's order;
* the files each reader saves decode to the JAX reader's saved pixels,
  under the JAX file names;
* ``imread``'s ``"color"``, ``"gray"`` and ``"unchanged"`` modes equal
  ``cv2.imread(IMREAD_COLOR)``, ``cv2.imread(IMREAD_GRAYSCALE)`` (libpng's
  fixed-point gray, libjpeg's Y plane) and ``imageio.imread`` over PNGs
  of every colour type and bit depth, interlaced or not, and JPEGs;
* ``FrameReader.write_files_to_video`` writes a Motion-JPEG AVI that
  ``cv2.VideoCapture`` opens with the JAX file's frame count, size and
  fps, at a PSNR no lower than the JAX file's; ``video_io.read_video``
  reads the port's AVI and cv2's, frame for frame as ``cv2.imdecode``.
"""

import io
import logging
import os
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from fgt_tpu.data import readers as jr
from fgt_tpu_torch.core import masks as tmasks
from fgt_tpu_torch.core import video_io
from fgt_tpu_torch.data import readers as tr
from fgt_tpu_torch.pipeline import image_io

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def write_png_raw(path, samples, ctype, depth, interlace=False,
                  palette=None):
    """A PNG of ``samples`` ([H, W] or [H, W, C]) as colour type ``ctype``
    at ``depth`` bits, Adam7-interlaced when asked (Pillow and cv2 write
    neither interlaced PNGs nor every depth)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, _ = samples.shape

    def rows(img):
        ph = img.shape[0]
        if depth == 16:
            return img.astype(">u2").view(np.uint8).reshape(ph, -1)
        if depth == 8:
            return img.astype(np.uint8).reshape(ph, -1)
        flat = img.reshape(ph, -1).astype(np.uint8)
        bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        return np.packbits(bits.reshape(ph, -1), axis=1)

    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\0" + r.tobytes() for r in rows(sub))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        data += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(data + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


def _frames(n, h, w, seed):
    rng = np.random.RandomState(seed)
    base = cv2.GaussianBlur((rng.rand(h, w + 4 * n, 3) * 255).astype(
        np.float32), (0, 0), 3)
    base = np.clip(base * 2.2 - 150, 0, 255).astype(np.uint8)
    return [base[:, 4 * i:4 * i + w] for i in range(n)]


def _exif(orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()


def _frame_folder(root, kind, n=5, h=36, w=52):
    """A folder of ``n`` frames of one kind, written by Pillow, cv2 or
    by hand."""
    d = os.path.join(root, kind)
    os.makedirs(d)
    for i, rgb in enumerate(_frames(n, h, w, seed=len(kind))):
        path = os.path.join(d, f"{i:05d}.{'jpg' if 'jpg' in kind else 'png'}")
        if kind == "rgb":
            Image.fromarray(rgb).save(path)
        elif kind == "rgba":
            Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1)).save(
                path)
        elif kind == "gray":
            Image.fromarray(rgb[..., 0]).save(path)
        elif kind == "palette":
            Image.fromarray(rgb).quantize(23).save(path)
        elif kind == "png16":
            cv2.imwrite(path, rgb.astype(np.uint16)[..., ::-1] * 257 + i)
        elif kind == "interlaced":
            write_png_raw(path, rgb, 2, 8, interlace=True)
        elif kind == "jpg_exif":
            Image.fromarray(rgb).save(path, quality=90,
                                      exif=_exif(6 if i % 2 else 3))
        elif kind == "jpg_progressive":
            cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                              1])
        elif kind == "jpg_cmyk":
            cmyk = np.concatenate([255 - rgb, rgb[..., :1] // 3], -1)
            Image.fromarray(cmyk, "CMYK").save(path, quality=90)
    return d


FRAME_KINDS = ["rgb", "rgba", "gray", "palette", "png16", "interlaced",
               "jpg_exif", "jpg_progressive", "jpg_cmyk"]


def _equal_lists(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_frame_reader_equals_jax(tmp_path, kind):
    d = _frame_folder(str(tmp_path), kind)
    for kw in ({}, {"resize": (40, 24)}, {"scale": 0.5},
               {"resize": (70, 51), "scale": 1.5},
               {"sample_period": 2, "max_length": 2}):
        got, want = tr.FrameReader(d, **kw), jr.FrameReader(d, **kw)
        assert got.filenames == want.filenames
        _equal_lists(got.files, want.files)
    out_t, out_j = tmp_path / "saved_t", tmp_path / "saved_j"
    got.save_files(str(out_t))
    want.save_files(str(out_j))
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in os.listdir(out_j):
        np.testing.assert_array_equal(cv2.imread(str(out_t / name)),
                                      cv2.imread(str(out_j / name)))


def _mask_folder(root, kind, n=4, h=40, w=56):
    """DAVIS-style masks: blobs that move, as palette PNGs (index 1),
    gray, RGB, 16-bit or interlaced PNGs, or gray / colour JPEGs."""
    d = os.path.join(root, kind)
    os.makedirs(d)
    strokes = tmasks.get_video_masks_by_moving_random_stroke(
        n, w, h, nStroke=3, brushWidthBound=(3, 8), seed=len(kind))
    for i, m in enumerate(strokes):
        m = m.copy()
        m[2:6, 2:5] = 255                        # a second component
        m[10:20, 40:50], m[13:17, 43:47] = 255, 0
        m[14, 44] = 255                          # nested in a hole
        path = os.path.join(d, f"{i:05d}.{'jpg' if 'jpg' in kind else 'png'}")
        if kind == "palette":
            img = Image.fromarray((m > 0).astype(np.uint8), "P")
            img.putpalette([0, 0, 0, 255, 200, 128] + [0] * 762)
            img.save(path)
        elif kind == "gray":
            Image.fromarray(m).save(path)
        elif kind == "rgb":
            Image.fromarray(np.stack([m, m // 2, 255 - m], -1)).save(path)
        elif kind == "png16":
            cv2.imwrite(path, m.astype(np.uint16) * 257)
        elif kind == "interlaced":
            write_png_raw(path, m, 0, 8, interlace=True)
        elif kind == "jpg_gray":
            Image.fromarray(m).save(path, quality=90, exif=_exif(8))
        elif kind == "jpg_color":
            cv2.imwrite(path, np.stack([m // 2, m, m], -1))
    return d


MASK_KINDS = ["palette", "gray", "rgb", "png16", "interlaced", "jpg_gray",
              "jpg_color"]


@pytest.mark.parametrize("kind", MASK_KINDS)
def test_mask_and_segmentation_readers_equal_jax(tmp_path, kind):
    d = _mask_folder(str(tmp_path), kind)
    got, want = tr.MaskReader(d), jr.MaskReader(d)
    _equal_lists(got.files, want.files)
    assert want.get_bboxes(0)
    for i in range(len(want)):
        assert got.get_bboxes(i) == want.get_bboxes(i)
        assert got.get_bbox(i) == want.get_bbox(i)
    seg_t, seg_j = tr.SegmentationReader(d), jr.SegmentationReader(d)
    _equal_lists(seg_t.files, seg_j.files)
    for reader_t, reader_j, name in ((got, want, "mask"),
                                     (seg_t, seg_j, "segm")):
        out_t, out_j = tmp_path / f"{name}_t", tmp_path / f"{name}_j"
        reader_t.save_files(str(out_t))
        reader_j.save_files(str(out_j))
        assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
        for f in os.listdir(out_j):
            np.testing.assert_array_equal(
                cv2.imread(str(out_t / f), cv2.IMREAD_UNCHANGED),
                cv2.imread(str(out_j / f), cv2.IMREAD_UNCHANGED))


def test_mask_generator_bbox_lists_and_save_frames_equal_jax(tmp_path):
    d = _mask_folder(str(tmp_path), "palette")
    boxes = [jr.MaskReader(d).get_bboxes(i) for i in range(4)]
    assert boxes == [tr.MaskReader(d).get_bboxes(i) for i in range(4)]
    gen_t = tr.MaskGenerator(str(tmp_path / "gen_t"), (56, 40), boxes)
    gen_j = jr.MaskGenerator(str(tmp_path / "gen_j"), (56, 40), boxes)
    _equal_lists(gen_t.files, gen_j.files)
    assert gen_t.get_bboxes(2) == gen_j.get_bboxes(2)
    assert sorted(os.listdir(tmp_path / "gen_t")) == \
        sorted(os.listdir(tmp_path / "gen_j"))
    _equal_lists(tr.MaskReader(str(tmp_path / "gen_t")).files,
                 jr.MaskReader(str(tmp_path / "gen_j")).files)
    lists = tr.BoundingBoxesListReader(None, read=False)
    lists.set_files(boxes)
    lists.save_files(str(tmp_path / "boxes"))
    for reader in (tr.BoundingBoxesListReader, jr.BoundingBoxesListReader):
        assert reader(str(tmp_path / "boxes")).files == boxes
    assert tr.BoundingBoxesListReader(str(tmp_path / "boxes"),
                                      sample_period=2).files == boxes[::2]
    frames = _frames(3, 20, 30, seed=4)
    tr.save_frames_to_dir(frames, str(tmp_path / "fr_t"))
    jr.save_frames_to_dir(frames, str(tmp_path / "fr_j"))
    assert sorted(os.listdir(tmp_path / "fr_t")) == [
        "frame_0000.png", "frame_0001.png", "frame_0002.png"]
    _equal_lists(tr.FrameReader(str(tmp_path / "fr_t")).files,
                 jr.FrameReader(str(tmp_path / "fr_j")).files)


def test_missing_directory_warns_as_jax(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        reader = tr.MaskReader(str(tmp_path / "absent"))
    assert len(reader) == 0
    assert "not exists" in caplog.text


def _png_cases(root):
    """PNGs of every colour type and bit depth, plain and interlaced, and
    ones with an eXIf orientation."""
    rng = np.random.RandomState(0)
    paths = []
    for h, w in ((1, 1), (9, 17), (23, 31)):
        for il in (False, True):
            for depth in (1, 2, 4, 8, 16):
                g = (rng.rand(h, w) * (1 << depth)).astype(
                    np.uint16 if depth == 16 else np.uint8)
                paths.append(os.path.join(root, f"g{depth}{il}{h}.png"))
                write_png_raw(paths[-1], g, 0, depth, il)
                if depth <= 8:
                    pal = (rng.rand(1 << depth, 3) * 255).astype(np.uint8)
                    paths.append(os.path.join(root, f"p{depth}{il}{h}.png"))
                    write_png_raw(paths[-1], g, 3, depth, il, pal)
                if depth >= 8:
                    for ctype in (2, 4, 6):
                        a = (rng.rand(h, w, CHANNELS[ctype]) * (1 << depth)
                             ).astype(g.dtype)
                        paths.append(os.path.join(
                            root, f"c{ctype}_{depth}{il}{h}.png"))
                        write_png_raw(paths[-1], a, ctype, depth, il)
    rgb = (rng.rand(13, 21, 3) * 255).astype(np.uint8)
    for o in (3, 6, 8):
        paths.append(os.path.join(root, f"exif{o}.png"))
        Image.fromarray(rgb).save(paths[-1], exif=_exif(o))
    return paths


def _jpeg_cases(root):
    rng = np.random.RandomState(1)
    rgb = cv2.GaussianBlur((rng.rand(29, 43, 3) * 255).astype(np.uint8),
                           (0, 0), 1.5)
    paths = []

    def add(name, data):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "wb") as f:
            f.write(data)

    for name, params in (("base420", []), ("prog", [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1]), ("s411", [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])):
        add(name + ".jpg", cv2.imencode(".jpg", rgb, params)[1].tobytes())
    add("gray.jpg", cv2.imencode(".jpg", rgb[..., 0])[1].tobytes())
    for o in (2, 5, 7):
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, "JPEG", exif=_exif(o))
        add(f"exif{o}.jpg", buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1), "CMYK").save(
        buf, "JPEG", progressive=True)
    add("cmyk.jpg", buf.getvalue())
    return paths


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_imread_modes_equal_cv2_and_imageio(tmp_path, fmt):
    """``"gray"`` is libpng's rgb-to-gray ((9797 R + 19234 G + 3737 B) >>
    15 on 8-bit data, rounded on 16-bit data before the high byte) and
    libjpeg's Y plane, not cv2.cvtColor; ``"color"`` expands gray and
    palettes and drops alpha; both apply EXIF orientation, which
    ``"unchanged"`` (imageio) ignores."""
    paths = _png_cases(str(tmp_path)) if fmt == "png" else \
        _jpeg_cases(str(tmp_path))
    for p in paths:
        name = os.path.basename(p)
        np.testing.assert_array_equal(
            image_io.imread(p, "color"),
            cv2.imread(p, cv2.IMREAD_COLOR)[..., ::-1], err_msg=name)
        np.testing.assert_array_equal(
            image_io.imread(p, "gray"), cv2.imread(p, cv2.IMREAD_GRAYSCALE),
            err_msg=name)
        got, want = image_io.imread(p, "unchanged"), imageio.imread(p)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if fmt == "png":          # the gray read is not cv2.cvtColor's
        p = os.path.join(str(tmp_path), "c2_8False23.png")
        rgb = cv2.imread(p)
        assert not np.array_equal(image_io.imread(p, "gray"),
                                  cv2.cvtColor(rgb, cv2.COLOR_BGR2GRAY))
    with pytest.raises(ValueError, match="mode"):
        image_io.imread(paths[0], "bgr")


def _psnr(a, b):
    err = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return 10 * np.log10(255.0 ** 2 / err)


def _capture(path):
    cap = cv2.VideoCapture(path)
    meta = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), cap.get(cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return meta, frames


def test_write_files_to_video_opens_in_cv2_as_jax(tmp_path):
    """bench.py's kind of frames (432x240), each written once and then
    twice (``frame_num_when_repeat_list``): the port's MJPG AVI opens in
    cv2.VideoCapture with the JAX file's count, size and fps, and comes
    back at a PSNR no lower than the JAX file's."""
    frames = _frames(6, 240, 432, seed=9)
    src = tmp_path / "frames"
    tr.save_frames_to_dir(frames, str(src))
    reps = (1, 2)
    tr.FrameReader(str(src)).write_files_to_video(str(tmp_path / "t.avi"),
                                                  6, reps)
    jr.FrameReader(str(src)).write_files_to_video(str(tmp_path / "j.avi"),
                                                  6, reps)
    want = [f for r in reps for f in frames for _ in range(r)]
    meta_t, got_t = _capture(str(tmp_path / "t.avi"))
    meta_j, got_j = _capture(str(tmp_path / "j.avi"))
    assert meta_t == meta_j == (18, 432, 240, 6.0)
    assert len(got_t) == len(got_j) == 18
    assert _psnr(got_t, want) >= _psnr(got_j, want)
    assert _psnr(got_t, want) >= 36
    # read_video reads both files as libjpeg decodes their frames
    for path in (tmp_path / "t.avi", tmp_path / "j.avi"):
        datas, fps = video_io.avi_frames(str(path))
        assert len(datas) == 18 and fps == 6
        back = video_io.read_video(str(path))
        for data, frame in zip(datas, back):
            np.testing.assert_array_equal(frame, cv2.imdecode(
                np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
    with open(tmp_path / "bad.avi", "wb") as f:
        f.write(b"RIFF\0\0\0\0WAVEfmt ")
    with pytest.raises(ValueError, match="bad.avi: not an AVI"):
        video_io.read_video(str(tmp_path / "bad.avi"))
