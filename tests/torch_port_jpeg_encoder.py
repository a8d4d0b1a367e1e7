"""JPEG writers for tests, in numpy: the port's baseline encoder
(``fgt_tpu_torch/core/jpeg_encode.py``, re-exported here) plus the
layouts the decoder must read and neither cv2 nor Pillow writes:

* :func:`write_scans` — any scan layout over quantised blocks:
  sequential files of several scans (non-interleaved, or a subset of
  components per scan), and progressive files from a scan script of
  (components, Ss, Se, Ah, Al), with DC and AC first and refinement
  scans, EOB runs and restart intervals; each scan's Huffman tables are
  made for its own symbols (every code of one length);
* :func:`component_blocks` — any integral sampling factors, 1, 3 or 4
  components, YCbCr, RGB, CMYK or YCCK planes (all but YCbCr carry an
  Adobe marker naming the transform);
* :data:`SIMPLE_PROGRESSION` — libjpeg's ``jpeg_simple_progression``
  for three components, and :data:`UNREFINED_PROGRESSION`, which stops
  every AC band at Al = 1 so that libjpeg's block smoothing runs.

    from torch_port_jpeg_encoder import encode_jpeg
    data = encode_jpeg(rgb_u8, quality=90, sampling="420")
"""

from __future__ import annotations

import struct

import numpy as np

from fgt_tpu_torch.core.jpeg_encode import (  # noqa: F401
    CHROMA_Q, LUMA_Q, SAMPLING, ZIGZAG, _category, _extra, _pack, _segment,
    encode_jpeg, quality_table, quantize_planes, quantized_blocks,
    rgb_to_ycc, subsample, write_jpeg)

# libjpeg jcparam.c jpeg_simple_progression, YCbCr
SIMPLE_PROGRESSION = [
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0)]
# the same bands, every AC coefficient left one bit short
UNREFINED_PROGRESSION = SIMPLE_PROGRESSION[:6] + [((0, 1, 2), 0, 0, 1, 0)]


def component_blocks(img: np.ndarray, quality: int, factors,
                     space: str = "ycc"):
    """(blocks, factors, tables) of ``img`` ([H, W] gray, [H, W, 3] RGB or
    [H, W, 4] CMYK) under per-component ``factors`` [(h, v), ...]:
    ``space`` "ycc" (RGB -> YCbCr), "rgb" or "cmyk" (the planes as they
    are) or "ycck" (C, M, Y inverted to R, G, B, then YCbCr, K as it is).
    Each component is box-averaged to its factors' share of the largest."""
    img = np.asarray(img)
    height, width = img.shape[:2]
    if img.ndim == 2:
        planes = [img.astype(np.float64)]
    elif space == "ycc":
        planes = list(rgb_to_ycc(img))
    elif space in ("cmyk", "rgb"):
        planes = [img[..., c].astype(np.float64)
                  for c in range(img.shape[2])]
    else:
        planes = list(rgb_to_ycc(255 - img[..., :3])) + [
            img[..., 3].astype(np.float64)]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    planes = [subsample(p, hmax // h, vmax // v)
              for p, (h, v) in zip(planes, factors)]
    tables = [quality_table(LUMA_Q, quality),
              quality_table(CHROMA_Q, quality)]
    table_of = [0, 1, 1, 0][:len(planes)]
    return (quantize_planes(planes, factors, tables, table_of, width,
                            height), list(factors), tables)


def _flat_table(symbols):
    """A Huffman table giving each used symbol a code of one length (the
    all-ones code left free): (BITS[1..16], HUFFVAL, {symbol: (code,
    length)})."""
    used = sorted(set(symbols)) or [0]
    length = max(1, int(np.ceil(np.log2(len(used) + 1))))
    bits = [0] * 16
    bits[length - 1] = len(used)
    return bits, used, {s: (i, length) for i, s in enumerate(used)}


class _Items:
    """The items of one restart interval: Huffman symbols (kind "dc" or
    "ac") and raw bits, coded once the scan's tables are known."""

    def __init__(self):
        self.items = []

    def sym(self, kind, s):
        self.items.append((kind, s, 0))

    def bits(self, value, n):
        if n:
            self.items.append(("bits", value & ((1 << n) - 1), n))


def _real_blocks(width, height, factors, c):
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    h, v = factors[c]
    return (-(-(-(-height * v // vmax)) // 8),
            -(-(-(-width * h // hmax)) // 8))


def _mcu_blocks(comps, blocks, factors, width, height):
    """Per MCU of a scan over ``comps``: the (component, block) pairs in
    coding order (jdinput.c per_scan_setup)."""
    if len(comps) == 1:
        c = comps[0]
        bh, bw = _real_blocks(width, height, factors, c)
        return [[(c, blocks[c][y, x])] for y in range(bh) for x in range(bw)]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    my, mx = -(-height // (8 * vmax)), -(-width // (8 * hmax))
    mcus = []
    for y in range(my):
        for x in range(mx):
            mcu = []
            for c in comps:
                h, v = factors[c]
                for by in range(v):
                    for bx in range(h):
                        mcu.append((c, blocks[c][y * v + by, x * h + bx]))
            mcus.append(mcu)
    return mcus


class _ScanCoder:
    """Items of one scan, following libjpeg's jcphuff.c (progressive) and
    jchuff.c (sequential) item by item."""

    def __init__(self, ss, se, ah, al, progressive):
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.progressive = progressive
        self.last_dc = {}
        self.eobrun = 0
        self.be = []                  # correction bits held by the EOB run

    def restart(self, out):
        self.flush_eobrun(out)
        self.last_dc = {}

    def flush_eobrun(self, out):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            out.sym("ac", n << 4)
            out.bits(self.eobrun, n)
            self.eobrun = 0
            for b in self.be:
                out.bits(b, 1)
            self.be = []

    def dc(self, out, c, value):
        diff = value - self.last_dc.get(c, 0)
        self.last_dc[c] = value
        size = int(_category(np.array([diff]))[0])
        out.sym("dc", size)
        out.bits(int(_extra(np.array([diff]), np.array([size]))[0]), size)

    def block(self, out, c, blk):
        zz = blk[ZIGZAG]
        if not self.progressive:
            self.dc(out, c, int(zz[0]))
            self.ac_first(out, zz, 1, 63, 0, eob_runs=False)
        elif self.ss == 0 and self.ah == 0:
            self.dc(out, c, int(zz[0]) >> self.al)
        elif self.ss == 0:
            out.bits((int(zz[0]) >> self.al) & 1, 1)
        elif self.ah == 0:
            self.ac_first(out, zz, self.ss, self.se, self.al, eob_runs=True)
        else:
            self.ac_refine(out, zz)

    def ac_first(self, out, zz, ss, se, al, eob_runs):
        vals = [(abs(int(v)) >> al) * (1 if v >= 0 else -1)
                for v in zz[ss:se + 1]]
        nz = [i for i, v in enumerate(vals) if v]
        if nz and eob_runs:
            self.flush_eobrun(out)
        run = 0
        for i, v in enumerate(vals):
            if not v:
                run += 1
                continue
            while run > 15:
                out.sym("ac", 0xF0)
                run -= 16
            size = abs(v).bit_length()
            out.sym("ac", (run << 4) | size)
            out.bits(v if v > 0 else v + (1 << size) - 1, size)
            run = 0
        if run:
            if not eob_runs:
                out.sym("ac", 0x00)
                return
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.flush_eobrun(out)

    def ac_refine(self, out, zz):
        al = self.al
        absv = [abs(int(v)) >> al for v in zz[self.ss:self.se + 1]]
        eob = max([i for i, a in enumerate(absv) if a == 1], default=-1)
        run, br = 0, []
        for i, a in enumerate(absv):
            if a == 0:
                run += 1
                continue
            while run > 15 and i <= eob:
                self.flush_eobrun(out)
                out.sym("ac", 0xF0)
                run -= 16
                for b in br:
                    out.bits(b, 1)
                br = []
            if a > 1:
                br.append(a & 1)
                continue
            self.flush_eobrun(out)
            out.sym("ac", (run << 4) | 1)
            out.bits(0 if zz[self.ss + i] < 0 else 1, 1)
            for b in br:
                out.bits(b, 1)
            br, run = [], 0
        if run or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 937:
                self.flush_eobrun(out)


def _code(intervals, tables):
    """Codes and lengths of a scan's items, RST markers between its
    restart intervals."""
    parts = []
    for i, items in enumerate(intervals):
        codes, lens = [], []
        for kind, v, n in items.items:
            if kind == "bits":
                codes.append(v)
                lens.append(n)
            else:
                code, length = tables[kind][2][v]
                codes.append(code)
                lens.append(length)
        if i:
            parts.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        parts.append(_pack(np.array(codes, np.int64),
                           np.array(lens, np.int64)))
    return b"".join(parts)


def write_scans(blocks, factors, tables, width: int, height: int, scans,
                progressive: bool = False, restart: int = 0,
                space: str = "ycc") -> bytes:
    """A JPEG of ``blocks`` / ``factors`` / ``tables`` (as
    :func:`quantized_blocks` or :func:`component_blocks` return them)
    coded in ``scans``: a list of (components, Ss, Se, Ah, Al); for a
    sequential file only the components count (Ss 0, Se 63, Ah = Al = 0).
    SOF2 when ``progressive``, else SOF1 (extended sequential, which a
    several-scan file is). ``space`` "rgb", "cmyk" or "ycck" writes an
    Adobe marker (transform 0, 0 or 2) in place of JFIF."""
    ncomp = len(blocks)
    out = [b"\xff\xd8"]
    if space != "ycc":
        out.append(_segment(0xEE, b"Adobe" + struct.pack(
            ">HHHB", 100, 0, 0, {"rgb": 0, "cmyk": 0, "ycck": 2}[space])))
    else:
        out.append(_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                  b"\x00\x00"))
    table_of = [0, 1, 1, 0][:ncomp]
    for t, q in enumerate(tables):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            q.astype(np.uint8)[ZIGZAG].tolist())))
    comp_bytes = b"".join(bytes([c + 1, (h << 4) | v, table_of[c]])
                          for c, (h, v) in enumerate(factors))
    out.append(_segment(0xC2 if progressive else 0xC1, struct.pack(
        ">BHHB", 8, height, width, ncomp) + comp_bytes))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    for comps, ss, se, ah, al in scans:
        if not progressive:
            ss, se, ah, al = 0, 63, 0, 0
        coder = _ScanCoder(ss, se, ah, al, progressive)
        intervals = [_Items()]
        for m, mcu in enumerate(_mcu_blocks(list(comps), blocks, factors,
                                            width, height)):
            if restart and m and m % restart == 0:
                coder.restart(intervals[-1])
                intervals.append(_Items())
            for c, blk in mcu:
                coder.block(intervals[-1], c, blk)
        coder.flush_eobrun(intervals[-1])
        tables_used = {}
        for kind, tc in (("dc", 0), ("ac", 1)):
            syms = [v for it in intervals for k, v, _ in it.items
                    if k == kind]
            if syms:
                tables_used[kind] = _flat_table(syms)
                bits, vals, _ = tables_used[kind]
                out.append(_segment(0xC4, bytes([tc << 4] + bits + vals)))
        out.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([c + 1, 0]) for c in comps) + bytes([ss, se,
                                                       (ah << 4) | al])))
        out.append(_code(intervals, tables_used))
    out.append(b"\xff\xd9")
    return b"".join(out)
