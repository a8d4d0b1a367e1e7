"""JPEG frames without cv2, imageio or PIL: the marker segments are parsed
here, the entropy-coded scans are decoded by ``csrc/jpeg_decode.cpp`` (a
host library built with g++ at first use, bound with ctypes), bit-equal
to libjpeg-turbo 3.1's default decompression as cv2 and Pillow run it
(islow IDCT, block smoothing, fancy upsampling, fixed-point colour
conversion).

Taken: 8-bit JPEGs, Huffman- or arithmetic-coded (the latter with the
conditioning of its DAC segments: DC L and U, AC K; 0, 1 and 5 without),
sequential (SOF0, SOF1, SOF9; one scan or several, interleaved or not)
or progressive (SOF2, SOF10: spectral selection and successive
approximation, EOB runs), with 1, 3 or 4 components (gray, YCbCr, RGB,
CMYK, YCCK), every integral sampling ratio (4:1:1 among them) and
restart intervals. Lossless files too (SOF3: Huffman-coded DPCM,
predictors 1-7, point transforms, precision 2-8, restart intervals of
whole rows; gray, RGB or CMYK, one scan, 1x1 sampling: what
libjpeg-turbo 3.1's encoder writes), with no colour conversion, as
libjpeg-turbo decodes them. Arithmetic-coded lossless (SOF11),
hierarchical and 12-bit files, lossless files labelled YCbCr (a JFIF or
Adobe marker says so) or YCCK or subsampled (which no reader here
decodes), non-integral sampling ratios and interleaved MCUs of more
than 10 blocks raise ``ValueError`` naming the file and the property;
so does a scan whose data is corrupt or ends before the image does.

The reference's readers differ, so the caller chooses
(:func:`decode_jpeg`'s ``mode``): ``cv2.imread`` applies the EXIF
orientation (the inference CLI, the dataset-preparation readers),
``imageio.imread`` does not (the datasets, validation, flow extraction
and the evaluation ground truth); they also differ on CMYK. A lossless
file decodes in cv2's modes only where the channels it asks for are the
file's (libjpeg-turbo converts no colour in lossless mode, and
``cv2.imread`` then returns None: :class:`ChannelMismatch`), and through
Pillow only at 8 bits.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from fgt_tpu_torch.ops import _build

SOI = b"\xff\xd8"

# zigzag position -> natural index (jutils.c jpeg_natural_order)
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_ERRORS = {-1: "a bad Huffman code", -2: "truncated entropy-coded data",
           -3: "a missing or out-of-order restart marker",
           -4: "a bad Huffman table", -5: "an unsupported layout",
           -6: "a bad arithmetic code"}

# sequential and progressive frames, Huffman- or arithmetic-coded, and
# Huffman-coded lossless ones
_TAKEN = {0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA}
_ARITH_TABLES = 16      # NUM_ARITH_TBLS


# the nine lowest AC coefficients (zigzag 1-9), whose precision decides
# libjpeg's block smoothing
_SMOOTH_POS = _NATURAL[:10]

_lock = threading.Lock()
_lib = None

_p = ctypes.c_void_p
_int = ctypes.c_int


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load_host_library("jpeg_decode")
            lib.jpeg_decode_scan.restype = _int
            lib.jpeg_decode_scan.argtypes = [_p, ctypes.c_int64, _p, _p, _p,
                                             _p, _p, _p]
            lib.jpeg_decode_output.restype = _int
            lib.jpeg_decode_output.argtypes = [_int, _p, _p, _p, _p, _int,
                                               _int, _p, _p, ctypes.c_int64,
                                               _p, _p, _p, _p, _p, _p]
            lib.jpeg_decode_lossless.restype = _int
            lib.jpeg_decode_lossless.argtypes = [_p, ctypes.c_int64, _p, _p,
                                                 _p, _p]
            _lib = lib
        return _lib


class ChannelMismatch(ValueError):
    """A lossless file read in a cv2 mode whose channel count is not the
    file's: ``cv2.imread`` returns None for it."""


def _sof_property(marker: int):
    """What keeps a SOFn frame from this decoder, or None for SOF0/1/2,
    their arithmetic-coded twins SOF9/10 and lossless SOF3."""
    if marker in _TAKEN:
        return None
    parts = []
    if marker >= 0xC9:
        parts.append("arithmetic-coded")
    if marker in (0xC2, 0xC6, 0xCA, 0xCE):
        parts.append("progressive")
    if marker in (0xC3, 0xC7, 0xCB, 0xCF):
        parts.append("lossless")
    if marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        parts.append("hierarchical")
    return " ".join(parts) + f" (SOF{marker - 0xC0})"


class _Scan:
    """One SOS: its components (frame indices), DC / AC table numbers,
    spectral band and approximation bits, the tables (Huffman, or the
    arithmetic conditioning of each component's: DC L, DC U, AC K) and
    restart interval in force, and where its entropy-coded bytes lie in
    the file (up to and with the marker that ends them)."""

    def __init__(self, comps, td, ta, ss, se, ah, al, restart, bits, vals,
                 conditioning, start, end):
        self.comps, self.td, self.ta = comps, td, ta
        self.ss, self.se, self.ah, self.al = ss, se, ah, al
        self.restart = restart
        self.bits, self.vals = bits, vals
        self.conditioning = conditioning
        self.start, self.end = start, end


class _Header:
    """The tables, frame and scans of one file, up to its EOI."""

    def __init__(self):
        self.quant = np.zeros((4, 64), np.uint16)
        self.quant_ok = [False] * 4
        self.bits = {0: np.zeros((4, 17), np.uint8),
                     1: np.zeros((4, 17), np.uint8)}
        self.vals = {0: np.zeros((4, 256), np.uint8),
                     1: np.zeros((4, 256), np.uint8)}
        self.huff_ok = {0: [False] * 4, 1: [False] * 4}
        self.restart = 0
        self.jfif = False
        self.adobe_transform = None
        self.exif = None
        self.progressive = False
        self.arith = False
        self.lossless = False
        self.precision = 8
        # jdmarker.c get_soi's arithmetic conditioning, until a DAC
        self.dc_l = [0] * _ARITH_TABLES
        self.dc_u = [1] * _ARITH_TABLES
        self.ac_k = [5] * _ARITH_TABLES
        self.frame = None       # (height, width, [(id, h, v, tq)])
        self.latched = {}       # frame component -> its quantisation table
        self.scans = []


def _scan_end(data: bytes, pos: int) -> int:
    """Where the entropy-coded data from ``pos`` ends: at the first marker
    other than RSTn (0xFF then a byte other than 0x00, 0xD0-0xD7 or 0xFF),
    or at the end of the file."""
    n = len(data)
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0:
            return n
        end = pos
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos < n and data[pos] != 0 and not 0xD0 <= data[pos] <= 0xD7:
            return end
        pos += 1


def _with_marker(data: bytes, end: int) -> int:
    """The end of a scan's bytes as the decoder takes them: past the
    marker that ends the scan at ``end`` (its fill bytes and code), so
    that it can tell a scan that reached its marker (after which
    arithmetic-coded data legally reads zeros) from a file cut short."""
    n = len(data)
    while end < n and data[end] == 0xFF:
        end += 1
    return min(end + 1, n)


def _parse(data: bytes, path: str) -> _Header:
    if data[:2] != SOI:
        raise ValueError(f"{path}: not a JPEG")
    hdr = _Header()
    pos, n = 2, len(data)
    while True:
        while pos < n and data[pos] != 0xFF:     # extraneous bytes
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break                                # no EOI: what was read
        marker = data[pos]
        pos += 1
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:
            break
        if marker == 0xD8:
            raise ValueError(f"{path}: a second SOI marker")
        if pos + 2 > n:
            raise ValueError(f"{path}: truncated marker segment")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) != length - 2:
            raise ValueError(f"{path}: truncated marker segment")
        pos += length
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            _frame(hdr, marker, seg, path)
        elif marker == 0xCC:
            _dac(hdr, seg, path)
        elif marker == 0xC4:
            _dht(hdr, seg, path)
        elif marker == 0xDB:
            _dqt(hdr, seg, path)
        elif marker == 0xDD:
            if len(seg) < 2:
                raise ValueError(f"{path}: bad DRI segment")
            hdr.restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xE0 and seg[:5] == b"JFIF\0":
            hdr.jfif = True
        elif marker == 0xE1 and seg[:6] == b"Exif\0\0" and hdr.exif is None:
            hdr.exif = seg[6:]
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            hdr.adobe_transform = seg[11]
        elif marker == 0xDC:
            raise ValueError(f"{path}: a DNL marker (height defined after "
                             f"the scan)")
        elif marker == 0xDA:
            end = _scan_end(data, pos)
            _sos(hdr, seg, path, pos, _with_marker(data, end))
            pos = end
    if not hdr.scans:
        raise ValueError(f"{path}: no scan before the end of the file")
    return hdr


def _frame(hdr: _Header, marker: int, seg: bytes, path: str) -> None:
    prop = _sof_property(marker)
    if prop is not None:
        raise ValueError(f"{path}: {prop} JPEG")
    if hdr.frame is not None:
        raise ValueError(f"{path}: more than one frame header")
    precision, height, width, ncomp = struct.unpack(">BHHB", seg[:6])
    lossless = marker == 0xC3
    if precision != 8 and not (lossless and 2 <= precision < 8):
        raise ValueError(f"{path}: {precision}-bit samples")
    if height == 0:
        raise ValueError(f"{path}: a DNL-defined height")
    if ncomp not in (1, 3, 4):
        raise ValueError(f"{path}: {ncomp} components (1, 3 and 4 are "
                         f"read)")
    comps = []
    for c in range(ncomp):
        cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
        comps.append((cid, hv >> 4, hv & 15, tq))
    if ncomp > 1:
        hmax = max(c[1] for c in comps)
        vmax = max(c[2] for c in comps)
        if any(not 1 <= c[1] <= 4 or not 1 <= c[2] <= 4
               or hmax % c[1] or vmax % c[2] for c in comps):
            raise ValueError(f"{path}: sampling factors " + ",".join(
                f"{c[1]}x{c[2]}" for c in comps) + " (only integral "
                "ratios are read)")
        if lossless and any(c[1:3] != (1, 1) for c in comps):
            raise ValueError(f"{path}: lossless with sampling factors "
                             + ",".join(f"{c[1]}x{c[2]}" for c in comps)
                             + " (only 1x1 is read)")
    else:   # one component: its factors do not shape the data
        comps = [(comps[0][0], 1, 1, comps[0][3])]
    hdr.lossless = lossless
    hdr.precision = precision
    hdr.progressive = marker in (0xC2, 0xCA)
    hdr.arith = marker >= 0xC9
    hdr.frame = (height, width, comps)


def _dht(hdr: _Header, seg: bytes, path: str) -> None:
    pos = 0
    while pos < len(seg):
        tc, th = seg[pos] >> 4, seg[pos] & 15
        if tc > 1 or th > 3:
            raise ValueError(f"{path}: bad Huffman table {tc}/{th}")
        bits = np.frombuffer(seg, np.uint8, 16, pos + 1)
        count = int(bits.sum())
        if count > 256 or pos + 17 + count > len(seg):
            raise ValueError(f"{path}: bad Huffman table {tc}/{th}")
        hdr.bits[tc][th] = np.concatenate([[0], bits])
        hdr.vals[tc][th] = 0
        hdr.vals[tc][th][:count] = np.frombuffer(seg, np.uint8, count,
                                                 pos + 17)
        hdr.huff_ok[tc][th] = True
        pos += 17 + count


def _dac(hdr: _Header, seg: bytes, path: str) -> None:
    """T.81 B.2.4.3 as jdmarker.c get_dac reads it: pairs of Tc/Tb and
    Cs; a DC table takes L = Cs & 15 and U = Cs >> 4 (L <= U), an AC
    table K = Cs (1 <= K <= 63)."""
    if len(seg) % 2:
        raise ValueError(f"{path}: bad DAC segment length")
    for at in range(0, len(seg), 2):
        index, cs = seg[at], seg[at + 1]
        if index >= 2 * _ARITH_TABLES:
            raise ValueError(f"{path}: bad DAC table {index >> 4}/"
                             f"{index & 15}")
        if index >= _ARITH_TABLES:
            if not 1 <= cs <= 63:
                raise ValueError(f"{path}: bad DAC AC conditioning K {cs}")
            hdr.ac_k[index - _ARITH_TABLES] = cs
        else:
            if cs & 15 > cs >> 4:
                raise ValueError(f"{path}: bad DAC DC conditioning L "
                                 f"{cs & 15} > U {cs >> 4}")
            hdr.dc_l[index], hdr.dc_u[index] = cs & 15, cs >> 4


def _dqt(hdr: _Header, seg: bytes, path: str) -> None:
    pos = 0
    while pos < len(seg):
        pq, tq = seg[pos] >> 4, seg[pos] & 15
        if pq > 1 or tq > 3:
            raise ValueError(f"{path}: bad quantisation table {pq}/{tq}")
        size = 64 * (pq + 1)
        if pos + 1 + size > len(seg):
            raise ValueError(f"{path}: truncated quantisation table")
        q = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, pos + 1)
        hdr.quant[tq][_NATURAL] = q
        hdr.quant_ok[tq] = True
        pos += 1 + size


def _sos(hdr: _Header, seg: bytes, path: str, start: int, end: int) -> None:
    if hdr.frame is None:
        raise ValueError(f"{path}: a scan before the frame header")
    comps = hdr.frame[2]
    ns = seg[0]
    if not 1 <= ns <= len(comps) or len(seg) < 4 + 2 * ns:
        raise ValueError(f"{path}: a scan of {ns} of {len(comps)} "
                         f"components")
    ids = [c[0] for c in comps]
    idx, td, ta = [], [], []
    for s in range(ns):
        cs, tables = seg[1 + 2 * s], seg[2 + 2 * s]
        if cs not in ids or ids.index(cs) in idx:
            raise ValueError(f"{path}: scan component {cs} not in the "
                             f"frame")
        idx.append(ids.index(cs))
        td.append(tables >> 4)
        ta.append(tables & 15)
    blocks = sum(comps[c][1] * comps[c][2] for c in idx)
    if ns > 1 and blocks > 10:
        raise ValueError(f"{path}: an interleaved scan of {blocks} blocks "
                         f"an MCU (at most 10)")
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if hdr.lossless:        # jdlossls.c start_pass_lossless checks
        if not 1 <= ss <= 7 or se != 0 or ah != 0 \
                or al >= hdr.precision:
            raise ValueError(f"{path}: bad lossless scan: predictor {ss}, "
                             f"Se {se}, point transform {ahal:#x}")
        if any(d > 3 or not hdr.huff_ok[0][d] for d in td):
            raise ValueError(f"{path}: a scan uses an undefined Huffman "
                             f"table")
        hdr.scans.append(_Scan(idx, td, ta, ss, se, ah, al, hdr.restart,
                               {k: v.copy() for k, v in hdr.bits.items()},
                               {k: v.copy() for k, v in hdr.vals.items()},
                               None, start, end))
        return
    if hdr.progressive:     # jdinput.c initial_setup / jdphuff.c checks
        dc = ss == 0
        if (dc and se != 0) or (not dc and (se < ss or se > 63 or ns != 1)) \
                or ah > 13 or al > 13:
            raise ValueError(f"{path}: bad progressive scan: spectral "
                             f"selection {ss}-{se}, approximation "
                             f"{ahal:#x}, {ns} components")
        use_dc, use_ac = dc and ah == 0, not dc
    else:
        ss, se, ah, al = 0, 63, 0, 0
        use_dc = use_ac = True
    for d, a in zip(td, ta):   # (arithmetic coding takes any of 16)
        if not hdr.arith and (d > 3 or a > 3
                              or (use_dc and not hdr.huff_ok[0][d])
                              or (use_ac and not hdr.huff_ok[1][a])):
            raise ValueError(f"{path}: a scan uses an undefined Huffman "
                             f"table")
    for c in idx:
        if c not in hdr.latched:   # jdinput.c latch_quant_tables
            tq = comps[c][3]
            if tq > 3 or not hdr.quant_ok[tq]:
                raise ValueError(f"{path}: a component uses an undefined "
                                 f"quantisation table")
            hdr.latched[c] = hdr.quant[tq].copy()
    hdr.scans.append(_Scan(idx, td, ta, ss, se, ah, al, hdr.restart,
                           {k: v.copy() for k, v in hdr.bits.items()},
                           {k: v.copy() for k, v in hdr.vals.items()},
                           [(hdr.dc_l[d], hdr.dc_u[d], hdr.ac_k[a])
                            for d, a in zip(td, ta)], start, end))


def _transform(hdr: _Header) -> str:
    """The colour space of the data (jdapimin.c default_decompress_parms'
    guess): "gray", "ycc", "rgb", "cmyk" or "ycck"."""
    ncomp = len(hdr.frame[2])
    if ncomp == 1:
        return "gray"
    if ncomp == 4:
        if hdr.adobe_transform is None or hdr.adobe_transform == 0:
            return "cmyk"
        return "ycck"
    if hdr.jfif:
        return "ycc"
    if hdr.adobe_transform is not None:
        return "rgb" if hdr.adobe_transform == 0 else "ycc"
    if hdr.lossless:     # libjpeg-turbo 3 assumes RGB whatever the ids
        return "rgb"
    ids = [c[0] for c in hdr.frame[2]]
    return "rgb" if ids == [82, 71, 66] else "ycc"


def exif_orientation(exif) -> int:
    """The Orientation tag (0x0112) of IFD0 of an APP1 EXIF payload (the
    bytes after ``Exif\\0\\0``), 1 when absent or unreadable."""
    if not exif or len(exif) < 8 or exif[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if exif[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", exif[4:8])[0]
    if ifd + 2 > len(exif):
        return 1
    count = struct.unpack(e + "H", exif[ifd:ifd + 2])[0]
    for i in range(count):
        at = ifd + 2 + 12 * i
        if at + 12 > len(exif):
            break
        tag, typ = struct.unpack(e + "HH", exif[at:at + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(e + "H", exif[at + 8:at + 10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The image as ``cv2.imread`` returns it under EXIF ``orientation``
    (its ApplyExifOrientation: flips, or a transpose then flips)."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_p)


def _check(err: int, path: str) -> None:
    if err:
        raise ValueError(f"{path}: {_ERRORS.get(err, f'error {err}')}")


def _one_pass(hdr: _Header) -> bool:
    """Whether the file is one sequential scan of every component, which
    decodes into buffers one iMCU row high, each row put out as soon as it
    is decoded (jdcoefct.c's single-pass controller); every other file
    decodes all its scans into a whole-image buffer first."""
    return not hdr.progressive and len(hdr.scans) == 1 \
        and len(hdr.scans[0].comps) == len(hdr.frame[2])


def _buffers(hdr: _Header, one_pass: bool):
    """The coefficient buffers: (per component [rows, pitch, 64] int16,
    of the whole image or of one iMCU row, per component (h, v,
    width_in_blocks, height_in_blocks), hmax, vmax)."""
    height, width, comps = hdr.frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    shapes, bufs = [], []
    for _, h, v, _ in comps:
        bw = -(-(-(-width * h // hmax)) // 8)
        bh = -(-(-(-height * v // vmax)) // 8)
        shapes.append((h, v, bw, bh))
        rows = v if one_pass else max(-(-bh // v) * v, mcus_y * v)
        pitch = max(-(-bw // h) * h, mcus_x * h)
        bufs.append(np.zeros((rows, pitch, 64), np.int16))
    return bufs, shapes, hmax, vmax


def _scan_args(hdr: _Header, scan: _Scan, data: np.ndarray, bufs, shapes,
               hmax: int, vmax: int) -> list:
    """The arguments of ``jpeg_decode_scan`` for one scan (of a one-pass
    file, the last eight of ``jpeg_decode_output``'s)."""
    height, width, _ = hdr.frame
    layout = [len(scan.comps), scan.ss, scan.se, scan.ah, scan.al,
              scan.restart, int(hdr.progressive), width, height, hmax, vmax,
              int(hdr.arith)]
    for c, d, a, cond in zip(scan.comps, scan.td, scan.ta,
                             scan.conditioning):
        layout += [*shapes[c], *bufs[c].shape[1::-1], d, a, *cond]
    layout = np.ascontiguousarray(layout, np.int32)
    coefs = (ctypes.c_void_p * len(scan.comps))(
        *(bufs[c].ctypes.data for c in scan.comps))
    return [_ptr(data[scan.start:]), scan.end - scan.start, _ptr(layout),
            coefs, _ptr(scan.bits[0]), _ptr(scan.vals[0]),
            _ptr(scan.bits[1]), _ptr(scan.vals[1])]


def _smoothing(hdr: _Header, quant: np.ndarray):
    """(whether libjpeg smooths the blocks, per component the Al of the
    last scan of zigzag 0-9, -1 where none came): jdcoefct.c
    smoothing_ok, on a progressive file once all of it is read."""
    ncomp = len(hdr.frame[2])
    bits = np.full((ncomp, 64), -1, np.int32)
    for scan in hdr.scans:
        for c in scan.comps:
            bits[c, scan.ss:scan.se + 1] = scan.al
    bits = np.ascontiguousarray(bits[:, :10])
    ok = hdr.progressive and len(hdr.latched) == ncomp \
        and bool((quant[:, _SMOOTH_POS] != 0).all()) \
        and bool((bits[:, 0] >= 0).all()) and bool((bits[:, 1:] != 0).any())
    return ok, bits


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """cv2's icvCvt_CMYK2BGR_8u_C4C3R, as RGB: each of c, m, y becomes
    k - ((255 - x) * k >> 8)."""
    x = cmyk.astype(np.int32)
    k = x[..., 3:]
    return (k - ((255 - x[..., :3]) * k >> 8)).astype(np.uint8)


def _rgb_to_gray(rgb: np.ndarray, cv2_weights: bool) -> np.ndarray:
    """Y of RGB samples: cv2's fixed point (14 bits, rounded) for the
    gray read of a CMYK file, or jdcolor.c's rgb_gray_convert (16 bits)
    for an RGB-coded one."""
    x = rgb.astype(np.int64)
    if cv2_weights:
        w, shift = (4899, 9617, 1868), 14
        y = (x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]
             + (1 << (shift - 1))) >> shift
    else:
        fix = [int(c * 65536 + 0.5) for c in (0.299, 0.587, 0.114)]
        y = (x[..., 0] * fix[0] + x[..., 1] * fix[1] + x[..., 2] * fix[2]
             + 32768) >> 16
    return y.astype(np.uint8)


MODES = ("unchanged", "color", "gray")


def _decode_lossless(hdr: _Header, payload: np.ndarray, path: str):
    """The samples of a lossless file, [H, W, components] uint8, as
    libjpeg-turbo decodes them (no colour conversion), or ValueError
    naming what no reader here decodes."""
    height, width, comps = hdr.frame
    ncomp = len(comps)
    space = _transform(hdr)
    if space in ("ycc", "ycck"):
        raise ValueError(f"{path}: lossless JPEG labelled "
                         f"{'YCbCr' if space == 'ycc' else 'YCCK'} (no "
                         f"colour conversion in lossless mode: no reader "
                         f"here decodes it)")
    if len(hdr.scans) != 1 or len(hdr.scans[0].comps) != ncomp:
        raise ValueError(f"{path}: lossless JPEG of {len(hdr.scans)} scans "
                         f"(one scan of every component is read)")
    scan = hdr.scans[0]
    if scan.restart % width:
        raise ValueError(f"{path}: lossless restart interval {scan.restart}"
                         f" not a multiple of the {width} MCUs of a row")
    layout = [ncomp, scan.ss, scan.al, scan.restart, width, height,
              hdr.precision, ncomp]
    for c, d in zip(scan.comps, scan.td):
        layout += [c, d]
    layout = np.ascontiguousarray(layout, np.int32)
    out = np.empty((height, width, ncomp), np.uint8)
    _check(_load().jpeg_decode_lossless(
        _ptr(payload[scan.start:]), scan.end - scan.start, _ptr(layout),
        _ptr(scan.bits[0]), _ptr(scan.vals[0]), _ptr(out)), path)
    return out, space


def _lossless_as(out: np.ndarray, space: str, hdr: _Header, mode: str,
                 path: str) -> np.ndarray:
    """A lossless file's samples as each reader returns them: Pillow (at 8
    bits only) gray, RGB or inverted CMYK; cv2 where the channels it asks
    for are the file's (gray from a gray file, colour from an RGB one) or
    from CMYK, which it converts itself."""
    if mode == "unchanged":
        if hdr.precision != 8:
            raise ValueError(f"{path}: lossless {hdr.precision}-bit "
                             f"samples (Pillow reads 8)")
        return {"gray": out[..., 0], "rgb": out}.get(space, 255 - out)
    if space == "cmyk":
        rgb = _cmyk_to_rgb(out)
        return rgb if mode == "color" else _rgb_to_gray(rgb, True)
    if (space == "gray") != (mode == "gray"):
        raise ChannelMismatch(
            f"{path}: lossless {space} JPEG read as {mode}: no colour "
            f"conversion in lossless mode (cv2.imread gives None)")
    return out[..., 0] if mode == "gray" else out


def decode_jpeg(data: bytes, path: str = "<bytes>",
                mode: str = "unchanged") -> np.ndarray:
    """Decode a JPEG as one of the reference's readers does:

    * ``"unchanged"`` — ``imageio.imread`` (Pillow): [H, W] uint8 of a
      one-component file, [H, W, 3] RGB of a three-component one,
      [H, W, 4] of a CMYK or YCCK one as Pillow returns it (libjpeg's
      CMYK, inverted: Pillow assumes Adobe's convention); EXIF
      orientation ignored;
    * ``"color"`` — ``cv2.imread(IMREAD_COLOR)`` as RGB: [H, W, 3]
      always, gray repeated, CMYK converted as cv2 converts it;
    * ``"gray"`` — ``cv2.imread(IMREAD_GRAYSCALE)``: [H, W], the Y
      samples of a YCbCr file as libjpeg's grayscale output gives them.

    The two cv2 modes apply the EXIF orientation as ``cv2.imread`` does.
    A lossless file read in a cv2 mode whose channels are not the file's
    raises :class:`ChannelMismatch` where cv2.imread returns None.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    hdr = _parse(data, path)
    payload = np.frombuffer(data, np.uint8)
    if hdr.lossless:
        out = _lossless_as(*_decode_lossless(hdr, payload, path), hdr, mode,
                           path)
        if mode != "unchanged":
            out = apply_orientation(out, exif_orientation(hdr.exif))
        return out
    height, width, comps = hdr.frame
    ncomp = len(comps)
    space = _transform(hdr)
    one_pass = _one_pass(hdr)
    bufs, shapes, hmax, vmax = _buffers(hdr, one_pass)
    lib = _load()
    scans = [_scan_args(hdr, scan, payload, bufs, shapes, hmax, vmax)
             for scan in hdr.scans]
    if not one_pass:
        for args in scans:
            _check(lib.jpeg_decode_scan(*args), path)
    quant = np.zeros((ncomp, 64), np.uint16)
    for c, table in hdr.latched.items():
        quant[c] = table
    smooth, coef_bits = _smoothing(hdr, quant)
    # libjpeg's colour conversion: 0 copy, 1 YCbCr -> RGB, 2 YCCK -> CMYK,
    # 3 component 0 alone (grayscale output of YCbCr)
    if mode == "gray" and space == "ycc":
        conv, nout = 3, 1
    else:
        conv = {"ycc": 1, "ycck": 2}.get(space, 0)
        nout = ncomp
    layout = [width, height, hmax, vmax]
    for shape, buf in zip(shapes, bufs):
        layout += [*shape, *buf.shape[1::-1]]
    layout = np.ascontiguousarray(layout, np.int32)
    coefs = (ctypes.c_void_p * ncomp)(*(b.ctypes.data for b in bufs))
    out = np.empty((height, width, nout), np.uint8)
    scan = scans[0] if one_pass else [None, 0] + [None] * 6
    _check(lib.jpeg_decode_output(ncomp, _ptr(layout), coefs, _ptr(quant),
                                  _ptr(coef_bits), int(smooth), conv,
                                  _ptr(out), *scan), path)
    if nout == 1:
        out = out[..., 0]
    if ncomp == 4:
        if mode == "unchanged":
            out = 255 - out
        elif mode == "color":
            out = _cmyk_to_rgb(out)
        else:
            out = _rgb_to_gray(_cmyk_to_rgb(out), cv2_weights=True)
    elif mode == "gray" and space == "rgb":
        out = _rgb_to_gray(out, cv2_weights=False)
    elif mode == "color" and ncomp == 1:
        out = np.repeat(out[..., None], 3, axis=-1)
    if mode != "unchanged":
        out = apply_orientation(out, exif_orientation(hdr.exif))
    return out


def read_jpeg(path: str, mode: str = "unchanged") -> np.ndarray:
    """Decode the JPEG file at ``path`` (see :func:`decode_jpeg`)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path, mode)
