"""The port's JPEG decoder (``fgt_tpu_torch/core/jpeg.py`` on
``csrc/jpeg_decode.cpp``) against libjpeg-turbo as cv2 and Pillow run
it, on the CPU: bit-equal over sizes 1x1 to 480x854, qualities 50-100,
gray and 4:4:4 / 4:2:2 / 4:2:0 / 4:4:0 / 4:1:1 and other integral
sampling, restart intervals 0, 1 and 3, optimised Huffman tables; baseline
and progressive files written by cv2, by Pillow and by the tests' own
encoders (``torch_port_jpeg_encoder.py``: progressive scan scripts, one
that leaves every AC coefficient unrefined so that libjpeg's block
smoothing runs, DC-only files, sequential files of several scans, RGB,
CMYK and YCCK); the three readers' semantics (``cv2.imread`` in colour
and in gray, ``imageio.imread``); EXIF orientations 1-8 applied as cv2
applies them and ignored as imageio ignores them; samples past the range
saturate as libjpeg-turbo's SIMD IDCT saturates them; 12-bit, lossless
(SOF3, SOF11) and hierarchical files raise. The committed fixtures under
``tests/data/jpeg/`` (which ``chip_smoke.py`` decodes on the card's
host) still equal cv2's decode; among them arithmetic-coded files (SOF9,
SOF10, DAC conditioning: 4:2:0 with restarts, gray, 4:4:4 under
non-default L, U and K beside its twin under the defaults, three
non-interleaved scans, simple and unrefined progressions, YCCK, and an
854x480 frame each way) written by libjpeg-turbo 2.1.5's own encoder
(``tests/data/jpeg/make_arith_fixtures.c``). Their cv2 5.0 decodes are
the PNGs beside them (of the 854x480 frames, a SHA-256 in
``arith_decodes.json``: their PNGs would take 780 KB each), and Pillow
12.1's decodes equal cv2's. Pillow reads an arithmetic-coded file only
when one decode block (``ImageFile.MAXBLOCK``, 64 KiB) holds all of it:
libjpeg's arithmetic decoder cannot suspend, so a larger file gives
"broken data stream"; the tests raise the block, and the port reads such
a file in every mode.

    python tests/test_torch_port_jpeg.py   # rewrite the fixtures (the
                                           # arithmetic ones need gcc and
                                           # libjpeg-turbo's libjpeg.a)
"""

import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from fgt_tpu_torch.core import jpeg
from fgt_tpu_torch.pipeline import image_io

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_jpeg_encoder import (  # noqa: E402
    SIMPLE_PROGRESSION, UNREFINED_PROGRESSION, component_blocks, encode_jpeg,
    quantized_blocks, write_jpeg, write_scans)

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
    applied = jpeg.read_jpeg(path, "color")
    np.testing.assert_array_equal(
        applied, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(jpeg.read_jpeg(path, "gray"),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    ignored = jpeg.read_jpeg(path, "unchanged")
    np.testing.assert_array_equal(ignored, imageio.imread(path))
    assert applied.shape == ((64, 40, 3) if orientation >= 5 else (40, 64, 3))


def _relabel(data: bytes, old: bytes, new: bytes) -> bytes:
    at = data.index(old)
    return data[:at] + new + data[at + len(new):]


def _unsupported(case: str) -> bytes:
    """A file the decoder refuses: baseline data announced under another
    SOF (its marker byte swapped), a 12-bit SOF1 header, a non-integral
    sampling ratio, an oversized MCU."""
    img = _image(32, 48, seed=4)
    base = _cv2_bytes(img, 90, "420", 0, 0)
    if case == "arithmetic-coded lossless (SOF11)":
        return _relabel(base, b"\xff\xc0", b"\xff\xcb")
    if case == "lossless (SOF3)":
        return _relabel(base, b"\xff\xc0", b"\xff\xc3")
    if case == "hierarchical (SOF5)":
        return _relabel(base, b"\xff\xc0", b"\xff\xc5")
    if case == "12-bit samples":     # a SOF1 header with precision 12
        sof = base.index(b"\xff\xc0")
        return base[:sof] + b"\xff\xc1" + base[sof + 2:sof + 4] + b"\x0c" \
            + base[sof + 5:]
    if case == "sampling factors 3x1,2x1,2x1":
        blocks, factors, tables = component_blocks(img, 90, [(3, 1)] * 3)
        data = write_scans(blocks, factors, tables, 48, 32,
                           [((0, 1, 2), 0, 63, 0, 0)])
        sof = data.index(b"\xff\xc1")
        return data[:sof + 14] + b"\x21" + data[sof + 15:sof + 17] + \
            b"\x21" + data[sof + 18:]
    if case == "11 blocks an MCU":
        blocks, factors, tables = component_blocks(img, 90, [(1, 1)] * 3)
        data = write_scans(blocks, factors, tables, 48, 32,
                           [((0, 1, 2), 0, 63, 0, 0)])
        sof = data.index(b"\xff\xc1")       # Y announced as 3x3
        return data[:sof + 11] + b"\x33" + data[sof + 12:]
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "lossless (SOF3)", "arithmetic-coded lossless (SOF11)",
    "hierarchical (SOF5)", "12-bit samples", "sampling factors 3x1,2x1,2x1",
    "11 blocks an MCU"])
def test_unsupported_files_raise_naming_file_and_property(tmp_path, case):
    """What the decoder refuses raises ValueError naming the file and the
    property (the encoders the tests use write no lossless, hierarchical
    or 12-bit files, so their headers are made by hand); so do a
    truncated file and one that is not a JPEG."""
    path = tmp_path / "bad.jpg"
    path.write_bytes(_unsupported(case))
    prop = re.escape(case.split(" (")[0] if "SOF" in case else case)
    with pytest.raises(ValueError, match=f"bad.jpg: .*{prop}"):
        jpeg.read_jpeg(str(path))
    if case == "12-bit samples":
        with pytest.raises(ValueError, match="truncated"):
            jpeg.decode_jpeg(_cv2_bytes(_image(32, 48, 4), 90, "420", 0,
                                        0)[:400])
        with pytest.raises(ValueError, match="not a JPEG"):
            jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def _pil_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_readers(data, label=""):
    """The decode under each reader's semantics equals that reader's."""
    arr = np.frombuffer(data, np.uint8)
    color = cv2.imdecode(arr, cv2.IMREAD_COLOR)
    assert color is not None, label
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, mode="color"),
                                  color[..., ::-1], err_msg=str(label))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, mode="gray"),
                                  cv2.imdecode(arr, cv2.IMREAD_GRAYSCALE),
                                  err_msg=str(label))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                  np.asarray(Image.open(io.BytesIO(data))),
                                  err_msg=str(label))


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_bit_equal_to_cv2_and_pillow(monkeypatch, size,
                                                 sampling):
    """Progressive files (libjpeg's simple progression: spectral
    selection, successive approximation, EOB runs) from cv2 at every
    quality and restart interval, and from Pillow, under the three
    readers' semantics (Pillow's progressive encode needs a block as
    large as the file)."""
    from PIL import ImageFile

    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 23)
    img = _image(*size, seed=11)
    src = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if sampling == "gray" \
        else img
    for quality in QUALITIES:
        for rst in (0, 1, 3):
            params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                      cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                      cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
            if sampling != "gray":
                params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           SAMPLINGS[sampling]]
            data = cv2.imencode(".jpg", src, params)[1].tobytes()
            _assert_readers(data, (quality, rst))
        pil = {"444": "4:4:4", "422": "4:2:2", "420": "4:2:0"}.get(sampling)
        if sampling == "gray" or pil:
            data = _pil_bytes(img[..., 1] if sampling == "gray" else img,
                              quality=quality, progressive=True,
                              **({"subsampling": pil} if pil else {}))
            _assert_readers(data, ("pil", quality))


@pytest.mark.parametrize("size", SIZES[1:-1], ids=lambda s: f"{s[0]}x{s[1]}")
def test_411_and_every_integral_ratio(size):
    """cv2's 4:1:1 (luma 4x1: libjpeg's int_upsample), baseline and
    progressive, then the test encoder's other integral ratios (3x1,
    1x4, 2x3, chroma above luma), each bit-equal."""
    img = _image(*size, seed=12)
    for prog in (0, 1):
        for rst in (0, 2):
            data = cv2.imencode(".jpg", img, [
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
                cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst])[1].tobytes()
            _assert_readers(data, ("411", prog, rst))
    for factors in ([(3, 1), (1, 1), (1, 1)], [(1, 4), (1, 2), (1, 1)],
                    [(2, 3), (1, 1), (1, 1)], [(1, 1), (2, 2), (1, 1)],
                    [(4, 2), (1, 1), (1, 1)], [(2, 2), (1, 2), (2, 1)]):
        blocks, f, tables = component_blocks(img, 85, factors)
        for scans, prog in (([((0, 1, 2), 0, 63, 0, 0)], False),
                            (SIMPLE_PROGRESSION, True)):
            data = write_scans(blocks, f, tables, size[1], size[0], scans,
                               prog, restart=3)
            _assert_readers(data, (factors, prog))


@pytest.mark.parametrize("size", [(17, 9), (37, 61), (120, 200), (150, 41),
                                  (240, 432)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_block_smoothing_bit_equal(size):
    """Progressive files whose last scans leave coefficients unrefined:
    libjpeg-turbo smooths their blocks from the 5x5 neighbourhood of DC
    values (every AC band stopped at Al = 1; nine AC coefficients only;
    DC alone, where it re-estimates the DC too), with luma factors of 2
    and 3 rows and odd block-row counts, where its edge rows are its own."""
    img = _image(*size, seed=13)
    scripts = {"unrefined": UNREFINED_PROGRESSION,
               "low band": [((0, 1, 2), 0, 0, 0, 2), ((0,), 1, 9, 0, 0),
                            ((0, 1, 2), 0, 0, 2, 1)],
               "dc only": [((0, 1, 2), 0, 0, 0, 0)],
               "separate dc": [((0,), 0, 0, 0, 1), ((1,), 0, 0, 0, 0),
                               ((2,), 0, 0, 0, 0), ((0,), 1, 63, 0, 1),
                               ((0,), 0, 0, 1, 0)]}
    for factors in ([(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)],
                    [(1, 1), (1, 1), (1, 1)], [(2, 3), (1, 1), (1, 1)],
                    [(1, 4), (1, 2), (1, 1)]):
        for quality in (50, 90):
            blocks, f, tables = component_blocks(img, quality, factors)
            for name, script in scripts.items():
                data = write_scans(blocks, f, tables, size[1], size[0],
                                   script, progressive=True,
                                   restart=5 if quality == 50 else 0)
                _assert_readers(data, (factors, quality, name))
    gray = img[..., 1]
    blocks, f, tables = component_blocks(gray, 75, [(1, 1)])
    data = write_scans(blocks, f, tables, size[1], size[0], [
        ((0,), 0, 0, 0, 1), ((0,), 1, 63, 0, 1), ((0,), 0, 0, 1, 0)],
        progressive=True)
    _assert_readers(data, "gray")


@pytest.mark.parametrize("size", SIZES[1:-1], ids=lambda s: f"{s[0]}x{s[1]}")
def test_sequential_files_of_several_scans(size):
    """SOF1 files coded in several scans (one per component, or luma
    alone then both chroma interleaved), with restarts: they share the
    progressive coefficient buffer. Beside them the same coefficients in
    one interleaved scan, which decodes an iMCU row at a time."""
    img = _image(*size, seed=14)
    for factors in ([(2, 2), (1, 1), (1, 1)], [(1, 1)] * 3,
                    [(4, 1), (1, 1), (1, 1)]):
        blocks, f, tables = component_blocks(img, 80, factors)
        for scans in ([((0,),), ((1,),), ((2,),)], [((0,),), ((1, 2),)],
                      [((2,),), ((0,),), ((1,),)], [((0, 1, 2),)]):
            for rst in (0, 4):
                data = write_scans(blocks, f, tables, size[1], size[0],
                                   [s + (0, 63, 0, 0) for s in scans],
                                   restart=rst)
                _assert_readers(data, (factors, scans, rst))


@pytest.mark.parametrize("size", [(1, 1), (17, 9), (37, 61), (240, 432)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cmyk_ycck_and_rgb_files(size):
    """Four-component files: Pillow's CMYK (Adobe transform 0, baseline
    and progressive, 4:4:4 and 4:2:0), the test encoder's CMYK and YCCK
    (transform 2), under cv2's colour and gray conversions and Pillow's
    inverted CMYK (which imageio returns); and an RGB-coded file (Adobe
    transform 0, three components), whose gray read is libjpeg's
    rgb_gray_convert."""
    h, w = size
    cmyk = np.concatenate([_image(h, w, seed=15), _image(h, w, 16)[..., :1]],
                          axis=-1)
    for quality in (50, 90, 100):
        for prog in (False, True):
            for sub in ("4:4:4", "4:2:0"):
                buf = io.BytesIO()
                Image.fromarray(cmyk, "CMYK").save(
                    buf, "JPEG", quality=quality, progressive=prog,
                    subsampling=sub)
                data = buf.getvalue()
                _assert_readers(data, (quality, prog, sub))
                np.testing.assert_array_equal(
                    jpeg.decode_jpeg(data), imageio.imread(io.BytesIO(data)))
    for space in ("cmyk", "ycck"):
        for factors in ([(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)]):
            blocks, f, tables = component_blocks(cmyk, 85, factors, space)
            for scans, prog in (([((0, 1, 2, 3), 0, 63, 0, 0)], False), ([
                    ((0, 1, 2, 3), 0, 0, 0, 1), ((0,), 1, 63, 0, 0),
                    ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0),
                    ((3,), 1, 63, 0, 0), ((0, 1, 2, 3), 0, 0, 1, 0)], True)):
                data = write_scans(blocks, f, tables, w, h, scans, prog,
                                   restart=2, space=space)
                _assert_readers(data, (space, factors, prog))
    blocks, f, tables = component_blocks(cmyk[..., :3], 90, [(1, 1)] * 3,
                                         "rgb")
    data = write_scans(blocks, f, tables, w, h, [((0, 1, 2), 0, 63, 0, 0)],
                       space="rgb")
    _assert_readers(data, "rgb")


def test_read_image_and_read_stack_take_png_and_jpg(tmp_path):
    """``image_io.imread`` picks the decoder by the file's signature;
    ``read_stack`` sorts ``*.png`` and ``*.jpg`` together, as the JAX
    CLI globs them (``*.JPG`` is not globbed, as there); orientation is
    applied by the cv2 modes only."""
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
    for mode in ("color", "unchanged"):
        np.testing.assert_array_equal(
            image_io.read_stack(str(video), mode), want)
        np.testing.assert_array_equal(
            image_io.imread(str(video / "00001.jpg"), mode), want[1])
    path = _with_orientation(tmp_path, 6)
    np.testing.assert_array_equal(image_io.imread(path, "color"),
                                  cv2.imread(path)[..., ::-1])
    np.testing.assert_array_equal(image_io.imread(path, "unchanged"),
                                  imageio.imread(path))
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        image_io.imread(str(video / "00004.JPG"), "unchanged")


def _fixture_files():
    return sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg"))


# The arithmetic-coded fixtures: the flags of make_arith_fixtures.c (q
# quality, s sampling, r restart interval, p simple progression, d DAC
# conditioning L,U,K, c ycck, S scan script) and the image each codes.
_UNREFINED_SCRIPT = "/".join(
    "".join(map(str, c)) + f":{ss}-{se}:{ah}:{al}"
    for c, ss, se, ah, al in UNREFINED_PROGRESSION)
ARITH_FIXTURES = {
    "arith_420_rst2": ("-q 85 -r 2", (37, 61, 30)),
    "arith_gray_q80": ("-q 80", (29, 33, 31, "gray")),
    "arith_444_q90": ("-s 444", (33, 47, 32)),
    "arith_444_q90_dac": ("-s 444 -d 2,6,20", (33, 47, 32)),
    "arith_seq_3scans_rst3": (
        "-s 422 -r 3 -S 0:0-63:0:0/1:0-63:0:0/2:0-63:0:0", (23, 37, 33)),
    "arith_prog_420_rst1": ("-q 80 -p -r 1", (25, 39, 34)),
    "arith_prog_unrefined_rst2": (f"-q 70 -r 2 -S {_UNREFINED_SCRIPT}",
                                  (35, 45, 35)),
    "arith_prog_gray": ("-p", (21, 35, 36, "gray")),
    "arith_ycck_q80": ("-q 80 -c ycck", (26, 38, 37, "cmyk")),
    "arith_854_420_q90": ("-q 90", "davis"),
    "arith_prog_854_420_q90": ("-q 90 -p", "davis"),
}
# cv2's decodes of the fixtures too large to commit as PNG: SHA-256 of
# the [H, W, 3] RGB bytes
ARITH_DECODES = os.path.join(FIXTURES, "arith_decodes.json")


def _decode_sha256(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb, np.uint8).tobytes()
                          ).hexdigest()


def _cv2_fixture_decode(name: str):
    """(the committed cv2 decode of fixture ``name`` as RGB, or None
    where only its hash is committed; that hash or None)."""
    png = os.path.join(FIXTURES, name[:-4] + ".png")
    if os.path.exists(png):
        return image_io.read_png(png), None
    with open(ARITH_DECODES) as f:
        return None, json.load(f)[name]


def test_committed_fixtures_equal_cv2():
    """The fixtures ``chip_smoke.py`` holds the card host's build to:
    each ``.jpg`` beside its ``.png``, which holds cv2.imread's RGB
    decode (orientation applied), or for the two 854x480 arithmetic
    frames beside that decode's SHA-256; all under 320 KB (200 KB before
    those two frames, 63 KB each, came)."""
    names = _fixture_files()
    assert len(names) >= 18 + len(ARITH_FIXTURES)
    assert set(ARITH_FIXTURES) <= {n[:-4] for n in names}
    total = sum(os.path.getsize(os.path.join(FIXTURES, f))
                for f in os.listdir(FIXTURES))
    assert total < 320_000, total
    for name in names:
        path = os.path.join(FIXTURES, name)
        want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
        png, digest = _cv2_fixture_decode(name)
        if png is None:
            assert _decode_sha256(want) == digest, name
        else:
            np.testing.assert_array_equal(png, want, err_msg=name)
        got = jpeg.read_jpeg(path, "color")
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name", sorted(ARITH_FIXTURES))
def test_arithmetic_fixtures_bit_equal(monkeypatch, name):
    """Each arithmetic-coded fixture (SOF9 or SOF10 as its name says, with
    its DAC segments) decodes bit-equal to its committed cv2 decode
    through ``read_jpeg``, and through ``image_io.imread`` as cv2.imread
    reads it in colour and in gray and as imageio.imread (Pillow, with a
    decode block that holds the file) reads it."""
    from PIL import ImageFile

    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 23)
    path = os.path.join(FIXTURES, name + ".jpg")
    with open(path, "rb") as f:
        data = f.read()
    sof = b"\xff\xca" if "_prog_" in name else b"\xff\xc9"
    assert sof in data and b"\xff\xcc" in data
    png, digest = _cv2_fixture_decode(name + ".jpg")
    got = jpeg.read_jpeg(path, "color")
    if png is None:
        assert _decode_sha256(got) == digest
    else:
        np.testing.assert_array_equal(got, png)
    np.testing.assert_array_equal(
        image_io.imread(path, "color"),
        cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(image_io.imread(path, "gray"),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    unchanged = image_io.imread(path, "unchanged")
    np.testing.assert_array_equal(unchanged, imageio.imread(path))
    np.testing.assert_array_equal(unchanged, np.asarray(Image.open(path)))


def test_dac_conditioning_decodes_as_the_defaults():
    """The same image coded under DAC conditioning L 2, U 6, K 20 and
    under the defaults (L 0, U 1, K 5): other bytes, the same pixels in
    every mode. Out-of-range conditioning raises, naming the file."""
    dac, default = (os.path.join(FIXTURES, f"arith_444_q90{s}.jpg")
                    for s in ("_dac", ""))
    with open(dac, "rb") as f:
        data = f.read()
    with open(default, "rb") as f:
        assert f.read() != data
    for path, cond in ((dac, (2, 6, 20)), (default, (0, 1, 5))):
        with open(path, "rb") as f:
            scans = jpeg._parse(f.read(), path).scans
        assert [scan.conditioning for scan in scans] == [[cond] * 3]
    for mode in jpeg.MODES:
        np.testing.assert_array_equal(jpeg.read_jpeg(dac, mode),
                                      jpeg.read_jpeg(default, mode))
    at = data.index(b"\xff\xcc") + 4       # the first Tc/Tb, Cs pair
    assert data[at:at + 2] == b"\x00\x62"
    for pair, what in ((b"\x00\x26", "L 6 > U 2"), (b"\x10\x00", "K 0"),
                       (b"\x10\x40", "K 64"), (b"\x20\x01", "table 2/0")):
        with pytest.raises(ValueError, match=f"dac.jpg: bad DAC .*{what}"):
            jpeg.decode_jpeg(data[:at] + pair + data[at + 2:], "dac.jpg")


def test_corrupt_or_truncated_arithmetic_scans_raise(tmp_path):
    """A scan cut short raises in every mode, as one of a Huffman file
    does: Pillow raises too, cv2.imread warns ("Premature end of JPEG
    file") and returns what it decoded. A scan of stuffed 0xFF bytes
    (all ones) raises "a bad arithmetic code" where libjpeg warns "bad
    arithmetic code" and decodes on: never a silent partial image."""
    with open(os.path.join(FIXTURES, "arith_420_rst2.jpg"), "rb") as f:
        data = f.read()
    path = tmp_path / "cut.jpg"
    path.write_bytes(data[:len(data) // 2])
    assert cv2.imread(str(path)) is not None
    with pytest.raises(OSError):
        np.asarray(Image.open(path))
    for mode in jpeg.MODES:
        with pytest.raises(ValueError, match="cut.jpg: truncated"):
            image_io.imread(str(path), mode)
    with open(os.path.join(FIXTURES, "arith_gray_q80.jpg"), "rb") as f:
        data = f.read()
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    path = tmp_path / "ones.jpg"
    path.write_bytes(data[:start] + b"\xff\x00" * 300 + b"\xff\xd9")
    assert cv2.imread(str(path)) is not None
    for mode in jpeg.MODES:
        with pytest.raises(ValueError, match="ones.jpg: a bad arithmetic"):
            image_io.imread(str(path), mode)


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
    # progressive from Pillow and cv2, with and without restarts
    files["pil_prog_420_q85"] = _pil_bytes(_image(27, 41, 17), quality=85,
                                           progressive=True)
    files["pil_prog_gray_q75"] = _pil_bytes(_image(22, 30, 18)[..., 0],
                                            quality=75, progressive=True)
    files["cv2_prog_420_rst1"] = cv2.imencode(".jpg", _image(25, 39, 19), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
        cv2.IMWRITE_JPEG_QUALITY, 80])[1].tobytes()
    files["cv2_prog_gray_rst2"] = cv2.imencode(
        ".jpg", _image(21, 35, 20)[..., 0], [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes()
    # the unrefined file (block smoothing), 4:1:1, CMYK, YCCK, several
    # sequential scans
    img = _image(35, 45, 21)
    blocks, factors, tables = component_blocks(img, 70, [(2, 2), (1, 1),
                                                         (1, 1)])
    files["encoder_prog_unrefined"] = write_scans(
        blocks, factors, tables, 45, 35, UNREFINED_PROGRESSION, True)
    files["cv2_411_q85"] = cv2.imencode(".jpg", _image(24, 44, 22), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
        cv2.IMWRITE_JPEG_QUALITY, 85])[1].tobytes()
    cmyk = np.concatenate([_image(26, 38, 23), _image(26, 38, 24)[..., :1]],
                          axis=-1)
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=85)
    files["pil_cmyk_q85"] = buf.getvalue()
    blocks, factors, tables = component_blocks(cmyk, 80, [(2, 2), (1, 1),
                                                          (1, 1), (2, 2)],
                                               "ycck")
    files["encoder_ycck"] = write_scans(blocks, factors, tables, 38, 26,
                                        [((0, 1, 2, 3), 0, 63, 0, 0)],
                                        space="ycck")
    blocks, factors, tables = component_blocks(_image(23, 37, 25), 80,
                                               [(2, 1), (1, 1), (1, 1)])
    files["encoder_seq_3scans_rst2"] = write_scans(
        blocks, factors, tables, 37, 23,
        [((c,), 0, 63, 0, 0) for c in range(3)], restart=2)
    files.update(_arith_files())
    decodes = {}
    for name, data in files.items():
        path = os.path.join(root, name + ".jpg")
        with open(path, "wb") as f:
            f.write(data)
        rgb = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
        if rgb.size > 200_000:
            decodes[name + ".jpg"] = _decode_sha256(rgb)
        else:
            image_io.write_png(path[:-4] + ".png", rgb)
    with open(os.path.join(root, os.path.basename(ARITH_DECODES)), "w") as f:
        json.dump(decodes, f, indent=1, sort_keys=True)
        f.write("\n")


def _arith_files() -> dict:
    """The arithmetic-coded fixtures, written by libjpeg-turbo's encoder
    (``make_arith_fixtures.c``, built here against its static library)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import davis_clip

    libjpeg = os.environ.get("LIBJPEG_A",
                             "/usr/lib/x86_64-linux-gnu/libjpeg.a")
    files = {}
    with tempfile.TemporaryDirectory() as d:
        exe = os.path.join(d, "make_arith_fixtures")
        subprocess.run(["gcc", "-O2", os.path.join(
            FIXTURES, "make_arith_fixtures.c"), libjpeg, "-lm", "-o", exe],
            check=True)
        for name, (flags, source) in ARITH_FIXTURES.items():
            if source == "davis":
                img = davis_clip(n=1)[0][0]
            else:
                h, w, seed, *kind = source
                img = _image(h, w, seed)
                if kind == ["gray"]:
                    img = img[..., 0].copy()
                elif kind == ["cmyk"]:
                    img = np.concatenate([img, _image(h, w, seed + 1)[
                        ..., :1]], axis=-1)
            raw = os.path.join(d, "in.raw")
            with open(raw, "wb") as f:
                ch = 1 if img.ndim == 2 else img.shape[2]
                f.write(f"{img.shape[1]} {img.shape[0]} {ch}\n".encode()
                        + np.ascontiguousarray(img).tobytes())
            out = os.path.join(d, "out.jpg")
            subprocess.run([exe, raw, out] + flags.split(), check=True)
            with open(out, "rb") as f:
                files[name] = f.read()
    return files


if __name__ == "__main__":
    write_fixtures()
