"""The port's JPEG decoder (``fgt_tpu_torch/core/jpeg.py`` on
``csrc/jpeg_decode.cpp``) against libjpeg-turbo as cv2 and Pillow run
it, on the CPU: bit-equal over sizes 1x1 to 480x854, qualities 50-100,
gray and 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 sampling, restart intervals 0, 1
and 3, optimised Huffman tables, files written by cv2, by Pillow and by
the tests' own baseline encoder (``torch_port_jpeg_encoder.py``); EXIF
orientations 1-8 applied as cv2 applies them and ignored as imageio
ignores them; samples past the range saturate as libjpeg-turbo's SIMD
IDCT saturates them; progressive, arithmetic-coded and 4:1:1 files
raise. The committed fixtures under ``tests/data/jpeg/`` (which
``chip_smoke.py`` decodes on the card's host) still equal cv2's decode.

    python tests/test_torch_port_jpeg.py   # rewrite the fixtures
"""

import io
import os
import re
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from fgt_tpu_torch.core import jpeg
from fgt_tpu_torch.pipeline import image_io

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_jpeg_encoder import (encode_jpeg, quantized_blocks,  # noqa: E402
                                     write_jpeg)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
SIZES = [(1, 1), (7, 5), (17, 9), (239, 431), (480, 854)]
QUALITIES = (50, 75, 90, 100)
SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "gray": None}


def _image(h, w, seed=0):
    """Smooth colour fields with noise and a few hard edges, so every
    coefficient band and the upsampler's edge cases are exercised."""
    rng = np.random.RandomState(seed + h * 1000 + w)
    base = rng.rand(h, w, 3).astype(np.float32) * 255
    if min(h, w) > 4:
        base = cv2.GaussianBlur(base, (0, 0), 2.0)
    img = base * 1.4 - 50 + rng.randn(h, w, 3) * 18
    img[h // 3:h // 2, w // 4:w // 2] = [250, 10, 120]
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_bytes(img, quality, sampling, rst, optimize):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize]
    if sampling == "gray":
        img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2_decode(data):
    """What ``cv2.imread`` returns, as RGB."""
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[
        ..., ::-1]


def _as_rgb(a):
    return np.stack([a] * 3, axis=-1) if a.ndim == 2 else a


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bit_equal_to_cv2_on_cv2_files(size, sampling):
    """Every quality x restart interval x Huffman-table choice of one
    size and sampling: the decode equals cv2.imread's, and Pillow's."""
    img = _image(*size)
    for quality in QUALITIES:
        for rst in (0, 1, 3):
            for optimize in (0, 1):
                data = _cv2_bytes(img, quality, sampling, rst, optimize)
                got = jpeg.decode_jpeg(data)
                case = (quality, rst, optimize)
                assert got.ndim == (2 if sampling == "gray" else 3)
                np.testing.assert_array_equal(_as_rgb(got), _cv2_decode(data),
                                              err_msg=str(case))
                pil = np.asarray(Image.open(io.BytesIO(data)))
                np.testing.assert_array_equal(got, pil, err_msg=str(case))


@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "gray"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bit_equal_to_pillow_on_pillow_files(tmp_path, monkeypatch, size,
                                             subsampling):
    """Pillow's encoder (its own tables and markers), every quality,
    standard and optimised Huffman tables (Pillow's optimised encode
    needs a block as large as the file)."""
    from PIL import ImageFile

    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 23)
    img = _image(*size, seed=1)
    path = tmp_path / "pil.jpg"
    for quality in QUALITIES:
        for optimize in (False, True):
            if subsampling == "gray":
                Image.fromarray(img[..., 1]).save(path, "JPEG",
                                                  quality=quality,
                                                  optimize=optimize)
            else:
                Image.fromarray(img).save(path, "JPEG", quality=quality,
                                          subsampling=subsampling,
                                          optimize=optimize)
            data = path.read_bytes()
            got = jpeg.decode_jpeg(data)
            want = np.asarray(Image.open(io.BytesIO(data)))
            np.testing.assert_array_equal(got, want,
                                          err_msg=str((quality, optimize)))
            np.testing.assert_array_equal(_as_rgb(got), _cv2_decode(data))


@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "gray"])
def test_baseline_test_encoder_round_trip(sampling):
    """The tests' baseline encoder (which writes the card's JPEG trees)
    writes files cv2 reads; the port's decode equals cv2's, and the image
    comes back about as close to the source as through cv2's encoder at
    the same quality and sampling (mean error within 1.25x + 0.5)."""
    for (h, w), rst in (((1, 1), 0), ((17, 9), 1), ((239, 431), 3),
                        ((480, 854), 0)):
        img = _image(h, w, seed=2)
        src = img[..., 0] if sampling == "gray" else img
        data = encode_jpeg(src, 90, "420" if sampling == "gray" else sampling,
                           rst)
        want = cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_UNCHANGED)
        assert want is not None, (h, w, rst)
        want = want[..., ::-1] if want.ndim == 3 else want
        got = jpeg.decode_jpeg(data)
        np.testing.assert_array_equal(got, want)
        if sampling == "gray":
            ref = cv2.imdecode(cv2.imencode(".jpg", src, [
                cv2.IMWRITE_JPEG_QUALITY, 90])[1], cv2.IMREAD_UNCHANGED)
        else:
            ref = _cv2_decode(_cv2_bytes(img, 90, sampling, 0, 0))
        err = np.abs(got.astype(int) - src).mean()
        assert err <= 1.25 * np.abs(ref.astype(int) - src).mean() + 0.5


def test_out_of_range_samples_saturate_as_libjpeg_turbo():
    """Coefficients whose IDCT leaves [-128, 127] far behind: jidctint.c
    would wrap them through RANGE_MASK, libjpeg-turbo's SIMD IDCT (cv2's
    and Pillow's) saturates them, and so does the port. One block holds
    only a DC term (the SIMD whole-block shortcut, shifted in 16 bits),
    the others AC terms too."""
    img = np.full((16, 16), 128, np.uint8)
    blocks, factors, tables = quantized_blocks(img, 1, "420")
    assert (tables[0] == 255).all()
    y = blocks[0]
    y[0, 0, 0] = 20                  # 5100 / 8 + 128: wraps in jidctint.c
    y[0, 1, 0] = -2000               # past 16 bits once dequantised
    y[1, 0, [0, 1]] = 12, 9
    y[1, 1, [0, 8]] = 3, -7
    data = write_jpeg(blocks, factors, tables, 16, 16)
    got = jpeg.decode_jpeg(data)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(data))))
    assert (got[:8, :8] == 255).all()        # jidctint.c's table gives 0


def _with_orientation(tmp_path, orientation):
    img = _image(40, 64, seed=3)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / f"o{orientation}.jpg")
    Image.fromarray(img).save(path, quality=90, exif=exif.tobytes())
    return path


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_applies_and_imageio_ignores(tmp_path,
                                                             orientation):
    path = _with_orientation(tmp_path, orientation)
    applied = jpeg.read_jpeg(path, orientation=True)
    np.testing.assert_array_equal(
        applied, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    ignored = jpeg.read_jpeg(path, orientation=False)
    np.testing.assert_array_equal(ignored, imageio.imread(path))
    assert applied.shape == ((64, 40, 3) if orientation >= 5 else (40, 64, 3))


def test_unsupported_files_raise_naming_file_and_property(tmp_path):
    img = _image(32, 48, seed=4)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cases = {"progressive": buf.tobytes()}
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    cases["4x1,1x1,1x1"] = buf.tobytes()
    # the same baseline data announced as arithmetic-coded (SOF9)
    data = bytearray(_cv2_bytes(img, 90, "420", 0, 0))
    sof = data.index(b"\xff\xc0")
    data[sof + 1] = 0xC9
    cases["arithmetic-coded"] = bytes(data)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True)
    cases["progressive (SOF2)"] = buf.getvalue()
    for prop, data in cases.items():
        path = tmp_path / "bad.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=f"bad.jpg: .*{re.escape(prop)}"):
            jpeg.read_jpeg(str(path), orientation=False)
    with pytest.raises(ValueError, match="truncated"):
        jpeg.decode_jpeg(_cv2_bytes(img, 90, "420", 0, 0)[:400])
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def test_read_image_and_read_stack_take_png_and_jpg(tmp_path):
    """``image_io.read_image`` picks the decoder by the file's signature;
    ``read_stack`` sorts ``*.png`` and ``*.jpg`` together, as the JAX
    CLI globs them (``*.JPG`` is not globbed, as there); orientation is
    applied only when asked."""
    video = tmp_path / "video"
    video.mkdir()
    exts = ["png", "jpg", "png", "jpg"]
    for i, ext in enumerate(exts):
        frame = _image(24, 40, seed=i)
        if ext == "png":
            image_io.write_png(str(video / f"{i:05d}.png"), frame)
        else:
            (video / f"{i:05d}.jpg").write_bytes(
                _cv2_bytes(frame, 90, "420", 0, 0))
    (video / "00004.JPG").write_bytes(b"")
    want = np.stack([cv2.imread(str(video / f"{i:05d}.{e}"),
                                cv2.IMREAD_COLOR)[..., ::-1]
                     for i, e in enumerate(exts)])
    for flag in (True, False):
        np.testing.assert_array_equal(
            image_io.read_stack(str(video), orientation=flag), want)
        np.testing.assert_array_equal(
            image_io.read_image(str(video / "00001.jpg"), flag), want[1])
    path = _with_orientation(tmp_path, 6)
    np.testing.assert_array_equal(image_io.read_image(path, True),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(image_io.read_image(path, False),
                                  imageio.imread(path))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        image_io.read_image(str(video / "00004.JPG"), orientation=False)


def _fixture_files():
    return sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))


def test_committed_fixtures_equal_cv2():
    """The fixtures ``chip_smoke.py`` holds the card host's build to:
    each ``.jpg`` beside its ``.png``, which holds cv2.imread's RGB
    decode (orientation applied); all under 200 KB."""
    names = _fixture_files()
    assert len(names) >= 8
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 200_000, total
    for name in names:
        path = os.path.join(FIXTURES, name)
        png = image_io.read_png(path[:-4] + ".png")
        np.testing.assert_array_equal(
            png, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], err_msg=name)
        np.testing.assert_array_equal(
            _as_rgb(jpeg.read_jpeg(path, orientation=True)), png,
            err_msg=name)


def write_fixtures(root: str = FIXTURES) -> None:
    """(Re)write the committed fixtures: cv2-, Pillow- and test-encoder-
    written files of every supported layout, small enough to commit."""
    os.makedirs(root, exist_ok=True)
    files = {
        "cv2_444_q90": _cv2_bytes(_image(37, 61, 5), 90, "444", 0, 0),
        "cv2_422_q75_rst1": _cv2_bytes(_image(37, 61, 6), 75, "422", 1, 0),
        "cv2_420_q50_opt_854": _cv2_bytes(_image(16, 854, 7), 50, "420", 0,
                                          1),
        "cv2_440_q100_rst3": _cv2_bytes(_image(23, 45, 8), 100, "440", 3, 0),
        "cv2_gray_q80": _cv2_bytes(_image(29, 33, 9), 80, "gray", 0, 0),
        "encoder_420_rst2": encode_jpeg(_image(33, 70, 10), 85, "420", 2),
    }
    buf = io.BytesIO()
    Image.fromarray(_image(31, 47, 11)).save(buf, "JPEG", quality=95,
                                             subsampling="4:2:0")
    files["pil_420_q95"] = buf.getvalue()
    buf = io.BytesIO()
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(_image(40, 64, 12)).save(buf, "JPEG", quality=90,
                                             exif=exif.tobytes())
    files["pil_exif6"] = buf.getvalue()
    blocks, factors, tables = quantized_blocks(np.full((16, 16), 128,
                                                       np.uint8), 1, "420")
    blocks[0][0, 0, 0], blocks[0][1, 1, [0, 8]] = 20, (3, -7)
    files["saturating_gray"] = write_jpeg(blocks, factors, tables, 16, 16)
    for name, data in files.items():
        path = os.path.join(root, name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        image_io.write_png(path[:-4] + ".png",
                           cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


if __name__ == "__main__":
    write_fixtures()
