"""The port's title text (``fgt_tpu_torch.core.text``) and its
``CompareFramesReader`` against OpenCV 5.0, fontTools and the JAX
package's ``fgt_tpu.data.readers``, on the CPU:

* outlines: every printable ASCII glyph and the composites "ä", "é",
  "Å" at ``wght`` 400, unrounded, equal fontTools' glyph set at the
  same normalised location (400 -> F2Dot14 -> ``avar``: 0.1875; fontTools
  itself does not round to F2Dot14) drawn through a
  ``DecomposingRecordingPen``, to 1e-6 units, with fontTools' ``HVAR``
  advance;
* OpenCV's integer outlines: synthetic variable glyphs (fontTools-built
  copies of the face with one glyph replaced) drawn by
  ``cv2.putText(..., cv2.FontFace(path), 150, weight)`` equal the port's
  coverage of the same glyph (a one-unit error in one point moves ~85
  pixels there), for IUP gaps inside a contour, past its last touched
  point with its first point touched and untouched, and an
  intermediate-region tuple whose 16.16 scalar truncates;
* rendering: each printable ASCII character and the titles, at three
  origins, on a uniform and a random background, on a small tile (the
  long title runs off it) and a 240 x 432 frame, equal
  ``cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 0), 1,
  LINE_AA)`` bit for bit; so does every character of Rubik's cmap alone;
  the two pen advances that do not match OpenCV's are pinned;
* the reader: ``CompareFramesReader`` over 2, 3 and 5 directories of
  unequal length, ``col`` default and 2, names default and given, equals
  the JAX reader's canvases, length and saved PNGs;
* a character outside Rubik's cmap, and any other face, scale,
  thickness or line type, raises ``ValueError``;
* the committed font is cv2's embedded member byte for byte, and the
  committed title strips (``tests/data/text``) equal a fresh cv2 render.
"""

import gzip
import hashlib
import importlib.util
import json
import os
import zlib

import cv2
import numpy as np
import pytest
from fontTools.pens.recordingPen import DecomposingRecordingPen
from fontTools.ttLib import TTFont
from fontTools.ttLib.tables import ttProgram
from fontTools.ttLib.tables.TupleVariation import TupleVariation
from fontTools.ttLib.tables._g_l_y_f import Glyph, GlyphCoordinates
from fontTools.varLib.models import normalizeValue, piecewiseLinearMap

from fgt_tpu.data import readers as jr
from fgt_tpu_torch.core import text
from fgt_tpu_torch.data import readers as tr
from fgt_tpu_torch.pipeline import image_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_DATA = os.path.join(ROOT, "tests", "data", "text")
ASCII = [chr(c) for c in range(32, 127)]
LONG = "a_very_long_directory_name_for_results_0123456789"
TITLES = ["davis_gt", "bmx-trees", "FGT (ours)", "result_0001", "AV To",
          "Über", "", LONG]
YELLOW = (255, 255, 0)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TEXT_DATA, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tt():
    with open(text.FONT_PATH, "rb") as f:
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"rubik_{os.getpid()}.ttf")
        with open(path, "wb") as out:
            out.write(gzip.decompress(f.read()))
    font = TTFont(path)
    yield font
    os.remove(path)


def _location(font):
    """wght 400 normalised as the OpenType rules say: rounded to F2Dot14
    before and after the ``avar`` map."""
    axis = font["fvar"].axes[0]
    n = normalizeValue(400, (axis.minValue, axis.defaultValue,
                             axis.maxValue))
    n = round(n * 16384) / 16384
    n = piecewiseLinearMap(n, font["avar"].segments["wght"])
    return {"wght": round(n * 16384) / 16384}


def _pen_value(contours):
    """The port's contours as a RecordingPen records a glyf glyph."""
    out = []
    for cont in contours:
        k0 = next((k for k, p in enumerate(cont) if p[2]), None)
        if k0 is None:
            out.append(("qCurveTo", tuple((x, y) for x, y, _ in cont)
                        + (None,)))
            out.append(("closePath", ()))
            continue
        start = (cont[k0][0], cont[k0][1])
        out.append(("moveTo", (start,)))
        offs = []
        for x, y, on in cont[k0 + 1:] + cont[:k0 + 1]:
            if not on:
                offs.append((x, y))
            elif offs:
                out.append(("qCurveTo", tuple(offs) + ((x, y),)))
                offs = []
            else:
                out.append(("lineTo", ((x, y),)))
        if offs:
            out.append(("qCurveTo", tuple(offs) + (start,)))
        elif out[-1][0] == "lineTo":
            out.pop()
        out.append(("closePath", ()))
    return out


def test_normalised_location(tt):
    face = text.rubik()
    assert face.normalize({"wght": 400}) == (3072,)
    assert _location(tt) == {"wght": 3072 / 16384}


@pytest.mark.parametrize("ch", ASCII + ["ä", "é", "Å"])
def test_outline_matches_fonttools(tt, ch):
    face = text.rubik()
    gid = face.cmap[ord(ch)]
    gs = tt.getGlyphSet(location=_location(tt), normalized=True)
    name = tt.getGlyphOrder()[gid]
    pen = DecomposingRecordingPen(gs)
    gs[name].draw(pen)
    mine = _pen_value(face.outline(gid, face.normalize({"wght": 400})))
    assert [op for op, _ in pen.value] == [op for op, _ in mine]
    for (_, want), (_, got) in zip(pen.value, mine):
        assert len(want) == len(got)
        for a, b in zip(want, got):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert face.advance(gid, face.normalize({"wght": 400})) == \
        pytest.approx(gs[name].width, abs=1e-9)
    if ch == "a":   # HVAR moves it: 536 at the default instance
        assert face.hmetrics(gid)[0] == 536
        assert gs[name].width == pytest.approx(552.125)


def _star_font(path, tt, touched, tuple_axes=(0.0, 1.0, 1.0)):
    """The face with "A" replaced by a 12-point star (every point on the
    curve) whose ``gvar`` moves only the ``touched`` points."""
    import copy

    font = copy.deepcopy(tt)
    pts = []
    for k in range(12):
        r = 350 if k % 2 == 0 else 170
        a = 2 * np.pi * k / 12
        pts.append((400 + int(r * np.cos(a)), 400 + int(r * np.sin(a))))
    g = Glyph()
    g.numberOfContours = 1
    g.coordinates = GlyphCoordinates(pts)
    g.flags = bytearray([1] * 12)
    g.endPtsOfContours = [11]
    g.program = ttProgram.Program()
    g.program.fromBytecode(b"")
    font["glyf"]["A"] = g
    g.recalcBounds(font["glyf"])
    font["hmtx"]["A"] = (font["hmtx"]["A"][0], g.xMin)
    deltas = [touched.get(k) for k in range(12)] + [None] * 4
    font["gvar"].variations["A"] = [TupleVariation(
        {"wght": tuple_axes}, deltas)]
    font.save(path)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("touched,weight,axes", [
    ({2: (30, -40), 6: (-50, 20)}, 900, (0.0, 1.0, 1.0)),
    ({0: (30, -40), 6: (-50, 20)}, 900, (0.0, 1.0, 1.0)),
    ({1: (30, -40), 6: (-50, 20), 9: (17, 41)}, 400, (0.0, 1.0, 1.0)),
    ({2: (30, -40), 5: (-50, 20), 11: (10, 10)}, 400, (0.0, 0.625, 1.0)),
], ids=["head-and-tail", "first-touched", "three-touched",
        "intermediate-region"])
def test_iup_matches_opencv(tt, tmp_path, touched, weight, axes):
    path = str(tmp_path / "star.ttf")
    face = text.Face(_star_font(path, tt, touched, axes))
    size, org = 150, (40, 120)
    ref = np.zeros((240, 240, 3), np.uint8)
    cv2.putText(ref, "A", org, (255, 255, 255), cv2.FontFace(path), size,
                weight)
    cov, x0, y0 = text.coverage(face, face.cmap[ord("A")],
                                face.normalize({"wght": weight}), size)
    out = np.zeros(ref.shape[:2], np.uint8)
    out[org[1] + y0:org[1] + y0 + cov.shape[0],
        org[0] + x0:org[0] + x0 + cov.shape[1]] = cov
    np.testing.assert_array_equal(out, ref[..., 0])


def _both(s, org, shape, background, color=YELLOW):
    rng = np.random.default_rng(zlib.crc32(repr((s, org, shape)).encode()))
    if background == "uniform":
        img = np.full(shape + (3,), 100, np.uint8)
    else:
        img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    ref, out = img.copy(), img.copy()
    cv2.putText(ref, s, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                cv2.LINE_AA)
    text.put_text(out, s, org, text.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                  text.LINE_AA)
    return ref, out


@pytest.mark.parametrize("s", ASCII + TITLES)
def test_put_text_matches_cv2(s):
    for org in ((6, 18), (0, 12), (7, 30)):
        for background in ("uniform", "random"):
            for shape in ((40, 60), (240, 432)):
                ref, out = _both(s, org, shape, background)
                np.testing.assert_array_equal(
                    out, ref, err_msg=f"{s!r} at {org} on {background} "
                    f"{shape}")


def test_every_cmap_character_matches_cv2():
    face = text.rubik()
    bad = []
    for u in sorted(face.cmap):
        ref, out = _both(chr(u), (40, 60), (90, 120), "random",
                         (255, 255, 255))
        if not np.array_equal(out, ref):
            bad.append(f"U+{u:04X}")
    assert not bad, bad
    assert len(face.cmap) == 885


@pytest.mark.parametrize("ch,offset", [("¨", -1), ("ײ", 1)])
def test_pinned_advance_residue(ch, offset):
    """After these two characters OpenCV's pen lands ``offset`` pixels
    from the port's (hmtx + HVAR advance, floored); every other
    character of the cmap advances alike (above, and the pairs here)."""
    img = np.zeros((40, 80, 3), np.uint8)
    cv2.putText(img, ch + "H", (20, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (255, 255, 255), 1, cv2.LINE_AA)
    title = text.Title(ch)
    found = []
    for d in (-1, 0, 1):
        mine = np.zeros_like(img)
        title.draw(mine, (20, 18), (255, 255, 255))
        text.Title("H").draw(mine, (20 + title.advance + d, 18),
                             (255, 255, 255))
        if np.array_equal(mine, img):
            found.append(d)
    assert found == [offset]


def test_blend_is_per_glyph_in_order():
    """Overlapping glyphs ("t" then "_" in "result_0001") blend in turn,
    not as one coverage: the title keeps a second layer."""
    title = text.render_text("result_0001")
    assert title.layers.shape[0] == 2
    ref, out = _both("result_0001", (6, 18), (40, 120), "random")
    np.testing.assert_array_equal(out, ref)


def _frames(root, name, n, h=40, w=64, seed=0):
    d = os.path.join(root, name)
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(d, f"{i:05d}.png"), img)
    return d


DIR_NAMES = ["davis_gt", "bmx-trees", "FGT (ours)", "result_0001", "v0"]


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("col", [None, 2])
@pytest.mark.parametrize("named", [False, True])
def test_reader_matches_jax(tmp_path, n, col, named):
    dirs = [_frames(str(tmp_path), DIR_NAMES[k], 3 + k, seed=k)
            for k in range(n)]
    names = [f"col {k} Über" for k in range(n)] if named else ()
    want = jr.CompareFramesReader(dirs, col=col, names=names)
    got = tr.CompareFramesReader(dirs, col=col, names=names)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    want.save_files(str(tmp_path / "jax"))
    got.save_files(str(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        f"compare_{i:04}.png" for i in range(3)]
    for f in files:
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "port" / f), cv2.IMREAD_UNCHANGED),
            cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_UNCHANGED))


def test_reader_pads_short_rows(tmp_path):
    dirs = [_frames(str(tmp_path), name, 2, seed=k)
            for k, name in enumerate(DIR_NAMES[:3])]
    got = tr.CompareFramesReader(dirs, col=2)
    assert got[0].shape == (80, 128, 3)
    assert not got[0][40:, 64:].any()
    np.testing.assert_array_equal(got[0][40:, :64][30:],
                                  cv2.imread(os.path.join(
                                      dirs[2], "00000.png"))[30:, :, ::-1])


def test_outside_cmap_raises():
    img = np.zeros((30, 80, 3), np.uint8)
    with pytest.raises(ValueError, match="日.*WenQuanYi"):
        text.put_text(img, "ok 日", (6, 18), text.FONT_HERSHEY_SIMPLEX,
                      0.5, YELLOW, 1, text.LINE_AA)
    assert not img.any()


def test_reader_outside_cmap_raises(tmp_path):
    d = _frames(str(tmp_path), "frames", 1)
    with pytest.raises(ValueError, match="日"):
        tr.CompareFramesReader([d], names=["日本"])


@pytest.mark.parametrize("args", [
    (cv2.FONT_HERSHEY_PLAIN, 0.5, 1, cv2.LINE_AA),
    (cv2.FONT_HERSHEY_SIMPLEX, 1.0, 1, cv2.LINE_AA),
    (cv2.FONT_HERSHEY_SIMPLEX, 0.5, 2, cv2.LINE_AA),
    (cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1, cv2.LINE_8),
])
def test_other_calls_raise(args):
    img = np.zeros((30, 80, 3), np.uint8)
    face, scale, thickness, line = args
    with pytest.raises(ValueError, match="ported"):
        text.put_text(img, "x", (6, 18), face, scale, YELLOW, thickness,
                      line)
    with pytest.raises(ValueError, match="uint8"):
        text.put_text(img.astype(np.float32), "x", (6, 18),
                      text.FONT_HERSHEY_SIMPLEX, 0.5, YELLOW, 1,
                      text.LINE_AA)


def test_committed_font_is_cv2s_member():
    extract = _load("extract_rubik")
    with open(extract.cv2_binary(), "rb") as f:
        member = extract.find_member(f.read())
    with open(text.FONT_PATH, "rb") as f:
        committed = f.read()
    assert committed == member
    digest = hashlib.sha256(gzip.decompress(committed)).hexdigest()
    assert digest == hashlib.sha256(gzip.decompress(member)).hexdigest()
    with open(os.path.join(os.path.dirname(text.FONT_PATH), "OFL.txt")) as f:
        licence = f.read()
    assert licence.startswith("Copyright 2015 The Rubik Project Authors")
    assert "SIL OPEN FONT LICENSE Version 1.1" in licence


def test_committed_strips_match_cv2():
    fixtures = _load("make_text_fixtures")
    with open(os.path.join(TEXT_DATA, "titles.json")) as f:
        titles = json.load(f)
    fresh = fixtures.renders()
    assert set(fresh) == set(titles)
    for fname, (name, img) in fresh.items():
        assert titles[fname] == name
        committed = image_io.imread(os.path.join(TEXT_DATA, fname), "color")
        np.testing.assert_array_equal(committed, img, err_msg=fname)
        background = np.zeros_like(img) if fname.startswith("on_black") \
            else fixtures.first_frame_strip()
        port = text.render_text(name).draw(background.copy(), fixtures.ORG,
                                           fixtures.COLOR)
        np.testing.assert_array_equal(port, img, err_msg=fname)
