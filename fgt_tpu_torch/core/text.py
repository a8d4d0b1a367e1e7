"""cv2-free text: the counterpart of the one ``cv2.putText`` call the
JAX package makes, ``CompareFramesReader``'s column titles
``putText(img, name, (6, 18), FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
LINE_AA)``, bit-equal to OpenCV 5.0's (``tests/test_torch_port_compare.py``).

OpenCV 5.0 has no Hershey stroke table: it draws ``FONT_HERSHEY_SIMPLEX``
at scale 0.5 and thickness 1 as its built-in "sans" TrueType face at
size 14 and weight 400, through its copy of stb_truetype. The face is
Rubik ("Rubik for OpenCV Light" 2.300, a variable font on ``wght``
300-900; ``fonts/Rubik.ttf.gz``, SIL OFL 1.1, ``fonts/OFL.txt``). This
module reads it with numpy and the standard library and draws as
OpenCV does:

* the instance: ``wght`` 400 normalised, rounded to F2Dot14 and mapped
  by ``avar`` to 3072 (0.1875);
* the outlines, in OpenCV's integer arithmetic
  (:meth:`Face.glyph_deltas_fixed`): each ``gvar`` tuple's scalar in
  16.16 with truncating divisions; the points a tuple leaves out
  filled by IUP on whole unscaled deltas, quotients truncated, with
  OpenCV's wrap-around (:func:`_iup_fixed`); ``(delta · scalar) >> 8``
  summed in 24.8 and floored to whole font units; a composite's
  components each varied on their own and moved by their whole-unit
  offsets. :meth:`Face.glyph_deltas` gives the unrounded outlines the
  OpenType rules define;
* the scale: 14 pixels to the ``hhea`` ascent (935 units);
* the glyphs: each one rasterised alone by stb_truetype's second
  rasteriser (exact signed-area coverage in float32, quadratic curves
  flattened to 0.35 px), emulated here operation for operation, in a
  bitmap padded by ``max((w + 9) // 10, (h + 9) // 10) + 10`` pixels
  on each side of its w x h box, as OpenCV pads it (the pad moves the
  float32 rounding);
* the layout: the pen starts at ``org`` with the baseline on row
  ``org.y``, and advances by ``floor(advance · scale)`` whole pixels a
  glyph, the advance being ``hmtx`` plus the ``HVAR`` delta; no
  kerning;
* the blend: each glyph's coverage ``a`` in turn,
  ``dst = (dst·(255 − a) + color·a + 127) // 255``, clipped at the
  image's edges.

All 885 characters of Rubik's cmap, drawn alone, and every title of
the tests equal OpenCV's. Two advances do not: after U+00A8 and
U+05F2 OpenCV moves the pen one pixel less and one more than the
``HVAR`` advance gives (the tests pin both).

A title is rasterised once (:func:`render_text`, a :class:`Title`) and
blended as often as needed (:meth:`Title.draw`). Characters that
OpenCV would draw from its fallback face (WenQuanYi Micro Hei, which
the port does not carry) raise ``ValueError``.
"""

from __future__ import annotations

import functools
import gzip
import math
import os
import struct

import numpy as np

FONT_HERSHEY_SIMPLEX = 0
LINE_AA = 16
FONT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "fonts", "Rubik.ttf.gz")
FALLBACK_FACE = "WenQuanYi Micro Hei"

# cv2's mapping of putText(FONT_HERSHEY_SIMPLEX, 0.5, thickness 1)
SIZE_PX = 14
WEIGHT = 400
FLATNESS_PX = 0.35

_F = np.float32


def _u16(b, o):
    return (b[o] << 8) | b[o + 1]


def _s16(b, o):
    v = (b[o] << 8) | b[o + 1]
    return v - 0x10000 if v & 0x8000 else v


def _u32(b, o):
    return struct.unpack_from(">I", b, o)[0]


def _tuple_scalar(coord, peak, start, end):
    """The scalar of one axis region at normalised ``coord`` (the
    OpenType ``gvar`` / item-variation-store rule)."""
    if peak == 0.0 or coord == peak:
        return 1.0
    if start > peak or peak > end or (start < 0.0 < end):
        return 1.0
    if coord <= start or coord >= end:
        return 0.0
    if coord < peak:
        return (coord - start) / (peak - start)
    return (end - coord) / (end - peak)


def _region_scalar(coord, peaks, starts, ends):
    """A region's scalar at ``coord``; all four in F2Dot14 integers."""
    s = 1.0
    for c, p, st, en in zip(coord, peaks, starts, ends):
        s *= _tuple_scalar(c / 16384.0, p / 16384.0, st / 16384.0,
                           en / 16384.0)
    return s


def _ctrunc(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _region_scalar_fixed(coord, peaks, starts, ends):
    """The same scalar as OpenCV computes it, in 16.16: 0x10000 scaled
    axis by axis by integer divisions that truncate."""
    s = 0x10000
    for c, p, st, en in zip(coord, peaks, starts, ends):
        if p == 0 or c == p or st > p or p > en or st < 0 < en:
            continue
        if c <= st or c >= en:
            return 0
        if c < p:
            s = _ctrunc(s * (c - st), p - st)
        else:
            s = _ctrunc(s * (en - c), en - p)
    return s


def _iup_axis(deltas, coords, touched, start, end):
    """Fills in the untouched points of one contour (indices
    ``start..end``) along one axis, as the OpenType IUP rule says."""
    idx = [i for i in range(start, end + 1) if touched[i]]
    if not idx:
        return
    if len(idx) == 1:
        d = deltas[idx[0]]
        for i in range(start, end + 1):
            if not touched[i]:
                deltas[i] = d
        return
    n = len(idx)
    for k in range(n):
        p1 = idx[k]
        p2 = idx[(k + 1) % n]
        i = p1 + 1 if p1 < end else start
        while i != p2:
            c1, c2 = coords[p1], coords[p2]
            d1, d2 = deltas[p1], deltas[p2]
            c = coords[i]
            if c1 == c2:
                deltas[i] = d1 if d1 == d2 else 0.0
            else:
                if c1 > c2:
                    c1, c2, d1, d2 = c2, c1, d2, d1
                if c <= c1:
                    deltas[i] = d1
                elif c >= c2:
                    deltas[i] = d2
                else:
                    deltas[i] = d1 + (c - c1) * (d2 - d1) / (c2 - c1)
            i = i + 1 if i < end else start


def _iup_ranges(ends):
    """The (first, last) point index of each contour."""
    return list(zip([0] + [e + 1 for e in ends[:-1]], ends))


def _interp_fixed(c, ca, cb, da, db):
    """One axis of OpenCV's IUP on whole units: the delta of the
    reference nearer ``c`` outside their span, inside it the linear
    interpolation with its quotient truncated toward zero."""
    if ca == cb:
        return da if da == db else 0
    if ca > cb:
        ca, cb, da, db = cb, ca, db, da
    if c <= ca:
        return da
    if c >= cb:
        return db
    return _ctrunc(da * (cb - ca) + (c - ca) * (db - da), cb - ca)


def _iup_fixed(tx, ty, coords, touched, start, end):
    """OpenCV 5.0's IUP of one contour (points ``start..end``) on whole
    unscaled deltas. An untouched point is interpolated between the
    touched point before it and the next touched one after it. Past the
    last touched point the search wraps to the contour's first point
    when that point is touched; when it is not, OpenCV has replaced its
    record of the contour's start by the last touched point, so the
    points after it copy that point's delta."""
    idx = [i for i in range(start, end + 1) if touched[i]]
    if not idx:
        return

    def interp(i, a, b):
        (c, cy), (ca, cay), (cb, cby) = coords[i], coords[a], coords[b]
        tx[i] = _interp_fixed(int(c), int(ca), int(cb), tx[a], tx[b])
        ty[i] = _interp_fixed(int(cy), int(cay), int(cby), ty[a], ty[b])

    if touched[start]:
        a, b, wrap = start, -1, start
    else:
        a, b, wrap = idx[-1], idx[0], idx[-1]
        interp(start, a, b)
    for i in range(start + 1, end + 1):
        if touched[i]:
            a = i
            if b == i:
                b = -1
            continue
        if b < 0:
            b = next((k for k in range(i + 1, end + 1) if touched[k]), wrap)
        interp(i, a, b)


class Face:
    """A TrueType face: the tables the renderer needs, read from the
    font's bytes. Coordinates are font units, y up."""

    def __init__(self, data: bytes):
        self.data = data
        b = data
        n = _u16(b, 4)
        self.tables = {}
        for i in range(n):
            o = 12 + 16 * i
            self.tables[b[o:o + 4].decode("latin-1")] = (_u32(b, o + 8),
                                                        _u32(b, o + 12))
        self.loca_long = _s16(b, self.tables["head"][0] + 50) != 0
        hhea = self.tables["hhea"][0]
        self.ascent = _s16(b, hhea + 4)
        self.n_hmetrics = _u16(b, hhea + 34)
        self.cmap = self._read_cmap()
        self.axes = self._read_fvar()
        self.avar = self._read_avar()
        self._read_gvar()
        self._read_hvar()

    # -- tables -------------------------------------------------------
    def _read_cmap(self):
        """Code point -> glyph id from the Unicode format-4 subtable."""
        b = self.data
        base = self.tables["cmap"][0]
        off = None
        for i in range(_u16(b, base + 2)):
            o = base + 4 + 8 * i
            sub = base + _u32(b, o + 4)
            if (_u16(b, o), _u16(b, o + 2)) in ((3, 1), (0, 3), (0, 4)) \
                    and _u16(b, sub) == 4:
                off = sub
                break
        if off is None:
            raise ValueError("font has no Unicode format-4 cmap subtable")
        cmap = {}
        segs = _u16(b, off + 6) // 2
        ends = off + 14
        starts = ends + 2 * segs + 2
        deltas = starts + 2 * segs
        ranges = deltas + 2 * segs
        for s in range(segs):
            end, start = _u16(b, ends + 2 * s), _u16(b, starts + 2 * s)
            delta, ro = _u16(b, deltas + 2 * s), _u16(b, ranges + 2 * s)
            for c in range(start, end + 1):
                if c == 0xFFFF:
                    continue
                if ro == 0:
                    gid = (c + delta) & 0xFFFF
                else:
                    gid = _u16(b, ranges + 2 * s + ro + 2 * (c - start))
                    if gid:
                        gid = (gid + delta) & 0xFFFF
                if gid:
                    cmap[c] = gid
        return cmap

    def _read_fvar(self):
        if "fvar" not in self.tables:
            return []
        b = self.data
        base = self.tables["fvar"][0]
        axes_off, count, size = (_u16(b, base + 4), _u16(b, base + 8),
                                 _u16(b, base + 10))
        axes = []
        for i in range(count):
            o = base + axes_off + size * i
            lo, default, hi = struct.unpack_from(">iii", b, o + 4)
            axes.append((b[o:o + 4].decode("latin-1"), lo / 65536.0,
                         default / 65536.0, hi / 65536.0))
        return axes

    def _read_avar(self):
        if "avar" not in self.tables:
            return None
        b = self.data
        o = self.tables["avar"][0] + 8
        maps = []
        for _ in range(len(self.axes)):
            n = _u16(b, o)
            maps.append([(_s16(b, o + 2 + 4 * k), _s16(b, o + 4 + 4 * k))
                         for k in range(n)])
            o += 2 + 4 * n
        return maps

    def _read_gvar(self):
        self._gvar = None
        if "gvar" not in self.tables:
            return
        b = self.data
        base = self.tables["gvar"][0]
        axis_count, shared_count = _u16(b, base + 4), _u16(b, base + 6)
        shared_off = base + _u32(b, base + 8)
        glyph_count, flags = _u16(b, base + 12), _u16(b, base + 14)
        data_off = base + _u32(b, base + 16)
        if flags & 1:
            offs = [data_off + _u32(b, base + 20 + 4 * i)
                    for i in range(glyph_count + 1)]
        else:
            offs = [data_off + 2 * _u16(b, base + 20 + 2 * i)
                    for i in range(glyph_count + 1)]
        shared = [tuple(_s16(b, shared_off + 2 * (k * axis_count + a))
                        for a in range(axis_count))
                  for k in range(shared_count)]
        self._gvar = (axis_count, shared, offs)

    def _read_hvar(self):
        self._hvar = None
        if "HVAR" not in self.tables:
            return
        b = self.data
        base = self.tables["HVAR"][0]
        store = base + _u32(b, base + 4)
        adv_map = _u32(b, base + 8)
        self._hvar = (store, base + adv_map if adv_map else None)

    # -- variations ---------------------------------------------------
    def normalize(self, user: dict) -> tuple:
        """User axis values -> normalised F2Dot14 integers, one per
        ``fvar`` axis: the default normalisation, rounded to F2Dot14,
        then the ``avar`` map, rounded again."""
        out = []
        for a, (tag, lo, default, hi) in enumerate(self.axes):
            v = min(max(float(user.get(tag, default)), lo), hi)
            if v < default:
                n = -(default - v) / (default - lo) if default > lo else 0.0
            elif v > default:
                n = (v - default) / (hi - default) if hi > default else 0.0
            else:
                n = 0.0
            q = int(math.floor(n * 16384 + 0.5))
            if self.avar is not None and self.avar[a]:
                q = _avar_map(self.avar[a], q)
            out.append(q)
        return tuple(out)

    def _tuples(self, gid: int, coord: tuple, n: int):
        """Glyph ``gid``'s ``gvar`` tuples that ``coord`` (normalised
        F2Dot14 integers) reaches: ``(peaks, starts, ends, points, dx,
        dy)``, ``points`` None when the tuple moves every one of the
        ``n`` points (phantom points included)."""
        if self._gvar is None or not any(coord):
            return
        axis_count, shared, offs = self._gvar
        b = self.data
        start, stop = offs[gid], offs[gid + 1]
        if stop <= start:
            return
        header = _u16(b, start)
        sdata = start + _u16(b, start + 2)
        o = start + 4
        shared_points = None
        if header & 0x8000:
            shared_points, sdata = _read_points(b, sdata)
        for _ in range(header & 0x0FFF):
            size, index = _u16(b, o), _u16(b, o + 2)
            o += 4
            if index & 0x8000:
                peaks = tuple(_s16(b, o + 2 * a) for a in range(axis_count))
                o += 2 * axis_count
            else:
                peaks = shared[index & 0x0FFF]
            if index & 0x4000:
                starts = tuple(_s16(b, o + 2 * a) for a in range(axis_count))
                ends = tuple(_s16(b, o + 2 * (axis_count + a))
                             for a in range(axis_count))
                o += 4 * axis_count
            else:
                starts = tuple(min(p, 0) for p in peaks)
                ends = tuple(max(p, 0) for p in peaks)
            here = sdata
            sdata += size
            if not _region_scalar_fixed(coord, peaks, starts, ends):
                continue
            if index & 0x2000:
                points, here = _read_points(b, here)
            else:
                points = shared_points
            m = n if points is None else len(points)
            vals, _ = _read_deltas(b, here, 2 * m)
            yield peaks, starts, ends, points, vals[:m], vals[m:]

    def glyph_deltas(self, gid: int, coord: tuple, coords, ends):
        """Per-point (dx, dy) of glyph ``gid`` at normalised ``coord``
        as the OpenType rules give them, unrounded: every tuple's
        deltas, IUP-filled on its own, times its scalar, summed.
        ``coords`` holds the glyph's points and four phantom points;
        ``ends`` its contours' last indices."""
        n = len(coords)
        dx = [0.0] * n
        dy = [0.0] * n
        for peaks, starts, ends_, points, vx, vy in self._tuples(gid, coord,
                                                                 n):
            scalar = _region_scalar(coord, peaks, starts, ends_)
            if points is None:
                tx, ty = vx, vy
            else:
                tx, ty = [0.0] * n, [0.0] * n
                touched = [False] * n
                for p, x, y in zip(points, vx, vy):
                    if p < n:
                        tx[p], ty[p], touched[p] = float(x), float(y), True
                for first, last in _iup_ranges(ends):
                    _iup_axis(tx, [c[0] for c in coords], touched, first,
                              last)
                    _iup_axis(ty, [c[1] for c in coords], touched, first,
                              last)
            for i in range(n):
                dx[i] += tx[i] * scalar
                dy[i] += ty[i] * scalar
        return dx, dy

    def glyph_deltas_fixed(self, gid: int, coord: tuple, coords, ends):
        """Per-point whole-unit (dx, dy) as OpenCV 5.0 computes them, in
        integers: each tuple's scalar in 16.16 (divisions truncated),
        the points a tuple leaves out filled by :func:`_iup_fixed` in
        whole units, ``(delta · scalar) >> 8`` summed in 24.8 and
        floored to whole units (``>> 8``)."""
        n = len(coords)
        ax = [0] * n
        ay = [0] * n
        for peaks, starts, ends_, points, vx, vy in self._tuples(gid, coord,
                                                                 n):
            scalar = _region_scalar_fixed(coord, peaks, starts, ends_)
            if points is None:
                tx, ty = vx, vy
            else:
                tx, ty = [0] * n, [0] * n
                touched = [False] * n
                for p, x, y in zip(points, vx, vy):
                    if p < n:
                        tx[p], ty[p], touched[p] = x, y, True
                for first, last in _iup_ranges(ends):
                    _iup_fixed(tx, ty, coords, touched, first, last)
            for i in range(n):
                ax[i] += (tx[i] * scalar) >> 8
                ay[i] += (ty[i] * scalar) >> 8
        return [v >> 8 for v in ax], [v >> 8 for v in ay]

    # -- glyphs -------------------------------------------------------
    def _glyph_range(self, gid):
        b = self.data
        loca = self.tables["loca"][0]
        if self.loca_long:
            a, e = _u32(b, loca + 4 * gid), _u32(b, loca + 4 * gid + 4)
        else:
            a, e = 2 * _u16(b, loca + 2 * gid), 2 * _u16(b, loca + 2 * gid + 2)
        g = self.tables["glyf"][0]
        return g + a, g + e

    def hmetrics(self, gid):
        b = self.data
        h = self.tables["hmtx"][0]
        k = min(gid, self.n_hmetrics - 1)
        adv = _u16(b, h + 4 * k)
        if gid < self.n_hmetrics:
            lsb = _s16(b, h + 4 * gid + 2)
        else:
            lsb = _s16(b, h + 4 * self.n_hmetrics
                       + 2 * (gid - self.n_hmetrics))
        return adv, lsb

    def advance(self, gid: int, coord: tuple) -> float:
        """The advance width at ``coord``: ``hmtx`` plus the ``HVAR``
        delta."""
        adv = float(self.hmetrics(gid)[0])
        if self._hvar is None or not any(coord):
            return adv
        store, adv_map = self._hvar
        b = self.data
        if adv_map is None:
            outer, inner = 0, gid
        else:
            fmt, entry = b[adv_map], b[adv_map + 1]
            if fmt == 0:
                count, data = _u16(b, adv_map + 2), adv_map + 4
            else:
                count, data = _u32(b, adv_map + 2), adv_map + 6
            size = ((entry & 0x30) >> 4) + 1
            inner_bits = (entry & 0x0F) + 1
            k = min(gid, count - 1)
            v = int.from_bytes(b[data + size * k:data + size * (k + 1)], "big")
            outer, inner = v >> inner_bits, v & ((1 << inner_bits) - 1)
        return adv + self._item_delta(store, outer, inner, coord)

    def _item_delta(self, store, outer, inner, coord):
        """Item (outer, inner) of the item variation store at ``store``:
        its deltas times their regions' scalars, summed."""
        b = self.data
        regions = store + _u32(b, store + 2)
        axis_count = _u16(b, regions)
        data = store + _u32(b, store + 8 + 4 * outer)
        word_count, region_count = _u16(b, data + 2), _u16(b, data + 4)
        long_words = bool(word_count & 0x8000)
        word_count &= 0x7FFF
        region_idx = [_u16(b, data + 6 + 2 * r) for r in range(region_count)]
        wsize, ssize = (4, 2) if long_words else (2, 1)
        row = word_count * wsize + (region_count - word_count) * ssize
        o = data + 6 + 2 * region_count + row * inner
        delta = 0.0
        for r, ri in enumerate(region_idx):
            if r < word_count:
                v = int.from_bytes(b[o:o + wsize], "big", signed=True)
                o += wsize
            else:
                v = int.from_bytes(b[o:o + ssize], "big", signed=True)
                o += ssize
            ro = regions + 4 + 6 * axis_count * ri
            starts = tuple(_s16(b, ro + 6 * a) for a in range(axis_count))
            peaks = tuple(_s16(b, ro + 6 * a + 2) for a in range(axis_count))
            ends = tuple(_s16(b, ro + 6 * a + 4) for a in range(axis_count))
            delta += v * _region_scalar(coord, peaks, starts, ends)
        return delta

    def _simple_points(self, off, ncont):
        b = self.data
        ends = [_u16(b, off + 10 + 2 * i) for i in range(ncont)]
        n = ends[-1] + 1 if ends else 0
        o = off + 10 + 2 * ncont
        o += 2 + _u16(b, o)
        flags = []
        while len(flags) < n:
            f = b[o]
            o += 1
            flags.append(f)
            if f & 8:
                flags.extend([f] * b[o])
                o += 1
        flags = flags[:n]
        coords = []
        for short, same in ((2, 16), (4, 32)):
            v, vals = 0, []
            for f in flags:
                if f & short:
                    d = b[o]
                    o += 1
                    v += d if f & same else -d
                elif not f & same:
                    v += _s16(b, o)
                    o += 2
                vals.append(v)
            coords.append(vals)
        pts = list(zip(*coords))
        return pts, [f & 1 for f in flags], ends

    def _components(self, off):
        b = self.data
        o = off + 10
        comps = []
        while True:
            flags, gid = _u16(b, o), _u16(b, o + 2)
            o += 4
            if flags & 1:
                a1, a2 = _s16(b, o), _s16(b, o + 2)
                o += 4
            else:
                a1, a2 = (int.from_bytes(b[o:o + 1], "big", signed=True),
                          int.from_bytes(b[o + 1:o + 2], "big", signed=True))
                o += 2
            if not flags & 2:
                raise ValueError("point-matched components are not supported")
            if flags & (8 | 0x40 | 0x80):
                raise ValueError("scaled components are not supported")
            comps.append((gid, a1, a2))
            if not flags & 0x20:
                return comps

    def _phantoms(self, gid, xmin):
        adv, lsb = self.hmetrics(gid)
        return [(xmin - lsb, 0), (xmin - lsb + adv, 0), (0, 0), (0, 0)]

    def outline(self, gid: int, coord: tuple, whole: bool = False):
        """Glyph ``gid`` at ``coord`` as contours of ``(x, y, on)``
        points in font units, composites decomposed. ``whole=False``:
        the OpenType rules, unrounded (:meth:`glyph_deltas`);
        ``whole=True``: the whole units OpenCV draws
        (:meth:`glyph_deltas_fixed`), each component moved by its own
        whole-unit offset."""
        a, e = self._glyph_range(gid)
        if e <= a:
            return []
        b = self.data
        ncont = _s16(b, a)
        xmin = _s16(b, a + 2)
        deltas = self.glyph_deltas_fixed if whole else self.glyph_deltas
        if ncont >= 0:
            pts, on, ends = self._simple_points(a, ncont)
            dx, dy = deltas(gid, coord, pts + self._phantoms(gid, xmin),
                            ends)
            return [[(pts[i][0] + dx[i], pts[i][1] + dy[i], on[i])
                     for i in range(first, last + 1)]
                    for first, last in _iup_ranges(ends)]
        comps = self._components(a)
        allp = [(x, y) for _, x, y in comps] + self._phantoms(gid, xmin)
        dx, dy = deltas(gid, coord, allp, list(range(len(allp))))
        out = []
        for i, (cg, x, y) in enumerate(comps):
            ox, oy = x + dx[i], y + dy[i]
            for cont in self.outline(cg, coord, whole):
                out.append([(px + ox, py + oy, o) for px, py, o in cont])
        return out


def _avar_map(segments, q):
    """``avar`` segment map on F2Dot14 integers (rounded)."""
    if q <= segments[0][0]:
        return segments[0][1] if q == segments[0][0] else q
    for (f0, t0), (f1, t1) in zip(segments, segments[1:]):
        if q == f1:
            return t1
        if f0 < q < f1:
            return t0 + int(math.floor((t1 - t0) * (q - f0) / (f1 - f0) + 0.5))
    return q


def _read_points(b, o):
    """Packed point numbers -> (list or None for all points, offset)."""
    count = b[o]
    o += 1
    if count & 0x80:
        count = ((count & 0x7F) << 8) | b[o]
        o += 1
    if count == 0:
        return None, o
    pts, p = [], 0
    while len(pts) < count:
        ctrl = b[o]
        o += 1
        run = (ctrl & 0x7F) + 1
        for _ in range(run):
            if ctrl & 0x80:
                p += _u16(b, o)
                o += 2
            else:
                p += b[o]
                o += 1
            pts.append(p)
    return pts[:count], o


def _read_deltas(b, o, count):
    """Packed deltas -> (list of ints, offset)."""
    vals = []
    while len(vals) < count:
        ctrl = b[o]
        o += 1
        run = (ctrl & 0x3F) + 1
        if ctrl & 0x80:
            vals.extend([0] * run)
        elif ctrl & 0x40:
            vals.extend(_s16(b, o + 2 * k) for k in range(run))
            o += 2 * run
        else:
            vals.extend(b[o + k] - 256 * (b[o + k] >> 7) for k in range(run))
            o += run
    return vals[:count], o


@functools.lru_cache(maxsize=1)
def rubik() -> Face:
    """The committed face, read once per process."""
    with open(FONT_PATH, "rb") as f:
        return Face(gzip.decompress(f.read()))


# -- stb_truetype's rasteriser, in float32 ---------------------------------

def _vertices(contours):
    """stb_truetype's ``GetGlyphShapeTT``: integer contours of ``(x, y,
    on)`` -> ``("m" | "l" | "q", x, y, cx, cy)`` vertices, two off-curve
    points in a row meeting at their integer midpoint (``>> 1``)."""
    verts = []
    for pts in contours:
        n = len(pts)
        x, y, on = pts[0]
        start_off = not on
        scx = scy = 0
        if start_off:
            scx, scy = x, y
            if not pts[1][2]:
                sx, sy = (x + pts[1][0]) >> 1, (y + pts[1][1]) >> 1
                first = 1
            else:
                sx, sy = pts[1][0], pts[1][1]
                first = 2
        else:
            sx, sy = x, y
            first = 1
        verts.append(("m", sx, sy, 0, 0))
        was_off = False
        cx = cy = 0
        for k in range(first, n):
            x, y, on = pts[k]
            if not on:
                if was_off:
                    verts.append(("q", (cx + x) >> 1, (cy + y) >> 1, cx, cy))
                cx, cy = x, y
                was_off = True
            else:
                verts.append(("q", x, y, cx, cy) if was_off
                             else ("l", x, y, 0, 0))
                was_off = False
        if start_off:
            if was_off:
                verts.append(("q", (cx + scx) >> 1, (cy + scy) >> 1, cx, cy))
            verts.append(("q", sx, sy, scx, scy))
        else:
            verts.append(("q", sx, sy, cx, cy) if was_off
                         else ("l", sx, sy, 0, 0))
    return verts


def _tesselate(points, x0, y0, x1, y1, x2, y2, flat2, n):
    mx = (x0 + _F(2) * x1 + x2) / _F(4)
    my = (y0 + _F(2) * y1 + y2) / _F(4)
    dx = (x0 + x2) / _F(2) - mx
    dy = (y0 + y2) / _F(2) - my
    if n > 16:
        return
    if dx * dx + dy * dy > flat2:
        _tesselate(points, x0, y0, (x0 + x1) / _F(2), (y0 + y1) / _F(2),
                   mx, my, flat2, n + 1)
        _tesselate(points, mx, my, (x1 + x2) / _F(2), (y1 + y2) / _F(2),
                   x2, y2, flat2, n + 1)
    else:
        points.append((x2, y2))


def _flatten(verts, flatness):
    """stb's ``FlattenCurves``: one float32 polyline a contour."""
    flat2 = _F(flatness) * _F(flatness)
    contours = []
    x = y = _F(0)
    for kind, vx, vy, cx, cy in verts:
        if kind == "m":
            contours.append([])
        if kind == "q":
            _tesselate(contours[-1], x, y, _F(cx), _F(cy), _F(vx), _F(vy),
                       flat2, 0)
        else:
            contours[-1].append((_F(vx), _F(vy)))
        x, y = _F(vx), _F(vy)
    return contours


def _sort_edges(p):
    """stb's ``sort_edges``: its median-of-three quicksort down to runs
    of 12, then an insertion sort, on ``y0``. It is not stable, and the
    order of edges that start on one row is the order in which their
    coverage is summed."""
    def quick(lo, n):
        while n > 12:
            m = n >> 1
            c01 = p[lo][0] < p[lo + m][0]
            c12 = p[lo + m][0] < p[lo + n - 1][0]
            if c01 != c12:
                c = p[lo][0] < p[lo + n - 1][0]
                z = lo if c == c12 else lo + n - 1
                p[z], p[lo + m] = p[lo + m], p[z]
            p[lo], p[lo + m] = p[lo + m], p[lo]
            i, j = 1, n - 1
            while True:
                while p[lo + i][0] < p[lo][0]:
                    i += 1
                while p[lo][0] < p[lo + j][0]:
                    j -= 1
                if i >= j:
                    break
                p[lo + i], p[lo + j] = p[lo + j], p[lo + i]
                i += 1
                j -= 1
            if j < n - i:
                quick(lo, j)
                lo, n = lo + i, n - i
            else:
                quick(lo + i, n - i)
                n = j

    quick(0, len(p))
    for i in range(1, len(p)):
        t = p[i]
        j = i
        while j > 0 and t[0] < p[j - 1][0]:
            p[j] = p[j - 1]
            j -= 1
        p[j] = t


class _Active:
    __slots__ = ("fx", "fdx", "fdy", "direction", "sy", "ey")


def _clipped(scan, x, e, x0, y0, x1, y1):
    """stb's ``handle_clipped_edge``: one segment's area in pixel x."""
    if y0 == y1 or y0 > e.ey or y1 < e.sy:
        return
    if y0 < e.sy:
        x0 = x0 + (x1 - x0) * (e.sy - y0) / (y1 - y0)
        y0 = e.sy
    if y1 > e.ey:
        x1 = x1 + (x1 - x0) * (e.ey - y1) / (y1 - y0)
        y1 = e.ey
    fx = _F(x)
    if x0 <= fx and x1 <= fx:
        scan[x] = scan[x] + e.direction * (y1 - y0)
    elif x0 >= fx + _F(1) and x1 >= fx + _F(1):
        pass
    else:
        scan[x] = scan[x] + e.direction * (y1 - y0) * (
            _F(1) - ((x0 - fx) + (x1 - fx)) / _F(2))


def _fill_active(scan, fill, width, active, y_top):
    """stb's ``fill_active_edges_new``; ``fill`` is its ``scanline2``
    (``scanline_fill`` is ``fill[1:]``)."""
    one, two = _F(1), _F(2)
    y_bottom = y_top + one
    for e in active:
        if e.fdx == 0:
            x0 = e.fx
            if x0 < width:
                if x0 >= 0:
                    _clipped(scan, int(x0), e, x0, y_top, x0, y_bottom)
                    _clipped(fill, int(x0) + 1, e, x0, y_top, x0, y_bottom)
                else:
                    _clipped(fill, 0, e, x0, y_top, x0, y_bottom)
            continue
        x0 = e.fx
        dx = e.fdx
        xb = x0 + dx
        dy = e.fdy
        if e.sy > y_top:
            x_top = x0 + dx * (e.sy - y_top)
            sy0 = e.sy
        else:
            x_top = x0
            sy0 = y_top
        if e.ey < y_bottom:
            x_bottom = x0 + dx * (e.ey - y_top)
            sy1 = e.ey
        else:
            x_bottom = xb
            sy1 = y_bottom
        if 0 <= x_top < width and 0 <= x_bottom < width:
            if int(x_top) == int(x_bottom):
                x = int(x_top)
                height = (sy1 - sy0) * e.direction
                right = _F(x) + one
                scan[x] = scan[x] + ((right - x_top) + (right - x_bottom)) \
                    / two * height
                fill[x + 1] = fill[x + 1] + height
                continue
            if x_top > x_bottom:
                sy0, sy1 = y_bottom - (sy1 - y_top), y_bottom - (sy0 - y_top)
                x_top, x_bottom = x_bottom, x_top
                dx, dy = -dx, -dy
                x0, xb = xb, x0
            x1, x2 = int(x_top), int(x_bottom)
            y_crossing = y_top + dy * (_F(x1 + 1) - x0)
            y_final = y_top + dy * (_F(x2) - x0)
            if y_crossing > y_bottom:
                y_crossing = y_bottom
            sign = e.direction
            area = sign * (y_crossing - sy0)
            scan[x1] = scan[x1] + area * (_F(x1 + 1) - x_top) / two
            if y_final > y_bottom:
                denom = x2 - (x1 + 1)
                y_final = y_bottom
                if denom != 0:
                    dy = (y_final - y_crossing) / _F(denom)
            step = sign * dy * one
            for x in range(x1 + 1, x2):
                scan[x] = scan[x] + (area + step / two)
                area = area + step
            right = _F(x2) + one
            scan[x2] = scan[x2] + (area + sign * (
                ((right - _F(x2)) + (right - x_bottom)) / two
                * (sy1 - y_final)))
            fill[x2 + 1] = fill[x2 + 1] + sign * (sy1 - sy0)
            continue
        # the edge leaves the bitmap: stb's brute-force clipped walk
        for x in range(width):
            y0 = y_top
            px1, px2 = _F(x), _F(x + 1)
            x3, y3 = xb, y_bottom
            y1 = (_F(x) - x0) / dx + y_top
            y2 = (_F(x + 1) - x0) / dx + y_top
            if x0 < px1 and x3 > px2:
                segs = ((x0, y0, px1, y1), (px1, y1, px2, y2),
                        (px2, y2, x3, y3))
            elif x3 < px1 and x0 > px2:
                segs = ((x0, y0, px2, y2), (px2, y2, px1, y1),
                        (px1, y1, x3, y3))
            elif x0 < px1 and x3 > px1:
                segs = ((x0, y0, px1, y1), (px1, y1, x3, y3))
            elif x3 < px1 and x0 > px1:
                segs = ((x0, y0, px1, y1), (px1, y1, x3, y3))
            elif x0 < px2 and x3 > px2:
                segs = ((x0, y0, px2, y2), (px2, y2, x3, y3))
            elif x3 < px2 and x0 > px2:
                segs = ((x0, y0, px2, y2), (px2, y2, x3, y3))
            else:
                segs = ((x0, y0, x3, y3),)
            for seg in segs:
                _clipped(scan, x, e, *seg)


def _rasterize(contours, width, height, scale, off_x, off_y, shift):
    """stb's ``rasterize`` + ``rasterize_sorted_edges`` (the second
    rasteriser, y down): float32 polylines in font units, mapped to
    ``p · scale + shift``, -> [height, width] uint8 coverage of the
    bitmap whose top-left pixel is (off_x, off_y)."""
    sx, sy = _F(shift[0]), _F(shift[1])
    edges = []
    for p in contours:
        j = len(p) - 1
        for k in range(len(p)):
            if p[j][1] != p[k][1]:
                a, b, inv = (j, k, True) if p[j][1] > p[k][1] else (k, j,
                                                                    False)
                edges.append((p[a][1] * -scale + sy, p[a][0] * scale + sx,
                              p[b][1] * -scale + sy, p[b][0] * scale + sx,
                              inv))
            j = k
    _sort_edges(edges)
    out = np.zeros((height, width), np.uint8)
    active = []
    ei = 0
    for j in range(height):
        y_top = _F(off_y + j)
        y_bottom = y_top + _F(1)
        scan = [_F(0)] * width
        fill = [_F(0)] * (width + 1)
        active = [z for z in active if not z.ey <= y_top]
        while ei < len(edges) and edges[ei][0] <= y_bottom:
            y0, x0, y1, x1, inv = edges[ei]
            ei += 1
            if y0 == y1:
                continue
            z = _Active()
            dxdy = (x1 - x0) / (y1 - y0)
            z.fdx = dxdy
            z.fdy = _F(1) / dxdy if dxdy != 0 else _F(0)
            z.fx = x0 + dxdy * (y_top - y0) - _F(off_x)
            z.direction = _F(1) if inv else _F(-1)
            z.sy, z.ey = y0, y1
            if j == 0 and off_y != 0 and z.ey < y_top:
                z.ey = y_top
            active.insert(0, z)
        if active:
            _fill_active(scan, fill, width, active, y_top)
        total = _F(0)
        for i in range(width):
            total = total + fill[i]
            k = _F(abs(scan[i] + total)) * _F(255) + _F(0.5)
            out[j, i] = min(int(k), 255)
        for z in active:
            z.fx = z.fx + z.fdx
    return out


# -- glyphs, layout, blend ------------------------------------------------

def _scale(face: Face, size: int = SIZE_PX):
    """stb's scale for OpenCV's pixel size: ``size`` to the ascent."""
    return _F(size) / _F(face.ascent)


def coverage(face: Face, gid: int, coord: tuple, size: int = SIZE_PX):
    """Glyph ``gid`` of ``face`` at ``coord`` and ``size`` pixels, as
    OpenCV rasterises it: ``(coverage [h, w] uint8, x0, y0)``, the
    bitmap's top-left pixel relative to the pen on the baseline, or None
    for a glyph with no outline. The h x w box is the glyph's whole-unit
    vertices (control points included) scaled and rounded outwards;
    OpenCV rasterises it inside a margin of ``pad`` pixels, the outline
    shifted by ``pad``."""
    verts = _vertices(face.outline(gid, coord, whole=True))
    if not verts:
        return None
    scale = _scale(face, size)
    xs = [v[1] for v in verts] + [v[3] for v in verts if v[0] == "q"]
    ys = [v[2] for v in verts] + [v[4] for v in verts if v[0] == "q"]
    x0 = math.floor(_F(min(xs)) * scale)
    y0 = math.floor(_F(-max(ys)) * scale)
    x1 = math.ceil(_F(max(xs)) * scale)
    y1 = math.ceil(_F(-min(ys)) * scale)
    w, h = x1 - x0, y1 - y0
    pad = max((w + 9) // 10, (h + 9) // 10) + 10
    contours = _flatten(verts, _F(FLATNESS_PX) / scale)
    cov = _rasterize(contours, w + 2 * pad, h + 2 * pad, scale, x0, y0,
                     (pad, pad))
    return cov[pad:pad + h, pad:pad + w], x0, y0


@functools.lru_cache(maxsize=None)
def glyph_bitmap(gid: int):
    """:func:`coverage` of the committed face's glyph ``gid`` at cv2's
    instance (``wght`` 400) and size (14 px), cached."""
    face = rubik()
    return coverage(face, gid, face.normalize({"wght": WEIGHT}))


def _glyph_id(face: Face, ch: str) -> int:
    gid = face.cmap.get(ord(ch))
    if gid is None:
        raise ValueError(
            f"character {ch!r} (U+{ord(ch):04X}) is not in Rubik's cmap: "
            f"OpenCV draws it from its fallback face {FALLBACK_FACE}, "
            f"which the port does not carry")
    return gid


class Title:
    """A string rasterised once: its glyphs' coverages as ``layers``
    [K, h, w] uint8 over the box whose top-left pixel is ``(x0, y0)``
    relative to ``org``, layer k holding each pixel's k-th nonzero
    coverage in glyph order (K > 1 only where glyphs overlap), so that
    blending the layers in turn blends every glyph in turn."""

    def __init__(self, text: str):
        face = rubik()
        coord = face.normalize({"wght": WEIGHT})
        scale = _scale(face)
        placed = []
        pen = 0
        for ch in text:
            gid = _glyph_id(face, ch)
            g = glyph_bitmap(gid)
            if g is not None:
                placed.append((g[0], pen + g[1], g[2]))
            pen += math.floor(_F(face.advance(gid, coord)) * scale)
        self.text = text
        self.advance = pen
        if not placed:
            self.x0 = self.y0 = 0
            self.layers = np.zeros((0, 0, 0), np.uint8)
            return
        x0 = min(x for _, x, _ in placed)
        y0 = min(y for _, _, y in placed)
        w = max(x + c.shape[1] for c, x, _ in placed) - x0
        h = max(y + c.shape[0] for c, _, y in placed) - y0
        layers = [np.zeros((h, w), np.uint8)]
        for cov, x, y in placed:
            ys, xs = np.nonzero(cov)
            vals = cov[ys, xs]
            ys, xs = ys + (y - y0), xs + (x - x0)
            for layer in layers:
                free = layer[ys, xs] == 0
                layer[ys[free], xs[free]] = vals[free]
                ys, xs, vals = ys[~free], xs[~free], vals[~free]
                if not len(vals):
                    break
            else:
                layers.append(np.zeros((h, w), np.uint8))
                layers[-1][ys, xs] = vals
        self.x0, self.y0 = x0, y0
        self.layers = np.stack(layers)

    def draw(self, img: np.ndarray, org, color) -> np.ndarray:
        """Blends the title onto ``img`` ([H, W, C] uint8, in place) with
        its pen at ``org`` = (x, baseline y), clipped at the edges."""
        if not self.layers.size:
            return img
        _, h, w = self.layers.shape
        top, left = int(org[1]) + self.y0, int(org[0]) + self.x0
        r0, c0 = max(top, 0), max(left, 0)
        r1, c1 = min(top + h, img.shape[0]), min(left + w, img.shape[1])
        if r0 >= r1 or c0 >= c1:
            return img
        a = self.layers[:, r0 - top:r1 - top, c0 - left:c1 - left]
        a = a.astype(np.int32)[..., None]
        col = np.asarray(color, np.int32)[:img.shape[2]]
        dst = img[r0:r1, c0:c1].astype(np.int32)
        for k in range(a.shape[0]):
            dst = (dst * (255 - a[k]) + col * a[k] + 127) // 255
        img[r0:r1, c0:c1] = dst.astype(np.uint8)
        return img


@functools.lru_cache(maxsize=256)
def render_text(text: str) -> Title:
    """The rasterised title of ``text`` (cached)."""
    return Title(text)


def put_text(img: np.ndarray, text: str, org, font_face: int,
             font_scale: float, color, thickness: int = 1,
             line_type: int = 8) -> np.ndarray:
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
    LINE_AA)`` on an [H, W, 3] uint8 image, in place; the call the JAX
    package makes and no other (other faces, scales, thicknesses and
    line types raise ``ValueError``)."""
    if (font_face, font_scale, thickness, line_type) != (
            FONT_HERSHEY_SIMPLEX, 0.5, 1, LINE_AA):
        raise ValueError(
            "only putText(FONT_HERSHEY_SIMPLEX, 0.5, thickness 1, LINE_AA) "
            f"is ported, not face {font_face}, scale {font_scale}, "
            f"thickness {thickness}, line type {line_type}")
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] uint8 image, got "
                         f"{img.dtype} {img.shape}")
    return render_text(text).draw(img, org, color)
