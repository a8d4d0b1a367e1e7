"""JPEG frames without cv2, imageio or PIL: the marker segments are parsed
here, the entropy-coded scan is decoded by ``csrc/jpeg_decode.cpp`` (a
host library built with g++ at first use, bound with ctypes), bit-equal
to libjpeg-turbo 3.1's default decompression as cv2 and Pillow run it
(islow IDCT, fancy upsampling, fixed-point YCbCr -> RGB).

Taken: sequential Huffman-coded 8-bit JPEGs (SOF0, SOF1) with 1 or 3
components in one scan, sampling 4:4:4, 4:2:2, 4:2:0 or 4:4:0, restart
intervals. Anything else (progressive, arithmetic-coded, lossless,
12-bit, CMYK/YCCK, other sampling factors, several scans) raises
``ValueError`` naming the file and the property.

The reference's readers differ on EXIF orientation, so the caller
chooses: ``cv2.imread`` applies it (the inference CLI), ``imageio.imread``
does not (the datasets, validation, flow extraction and the evaluation
ground truth).
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
           -4: "a bad Huffman table", -5: "an unsupported layout"}

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
            lib.jpeg_decode_scan.argtypes = [
                _p, ctypes.c_int64, _int, _int, _int, _p, _p, _p, _p, _p, _p,
                _p, _p, _p, _p, _p, _int, _int, _p]
            _lib = lib
        return _lib


def _sof_property(marker: int):
    """What keeps a SOFn frame from this decoder, or None for SOF0/1."""
    if marker in (0xC0, 0xC1):
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


class _Header:
    """The tables and layout of one sequential frame, up to its SOS."""

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
        self.frame = None       # (height, width, [(id, h, v, tq)])
        self.scan = None        # [(frame index, td, ta)]
        self.data_start = 0


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
            raise ValueError(f"{path}: no scan before the end of the file")
        marker = data[pos]
        pos += 1
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if marker in (0xD8, 0xD9):
            raise ValueError(f"{path}: no scan before marker {marker:#x}")
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
            raise ValueError(f"{path}: arithmetic-coded (DAC marker)")
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
            _sos(hdr, seg, path)
            hdr.data_start = pos
            return hdr


def _frame(hdr: _Header, marker: int, seg: bytes, path: str) -> None:
    prop = _sof_property(marker)
    if prop is not None:
        raise ValueError(f"{path}: {prop} JPEG")
    if hdr.frame is not None:
        raise ValueError(f"{path}: more than one frame header")
    precision, height, width, ncomp = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise ValueError(f"{path}: {precision}-bit samples")
    if height == 0:
        raise ValueError(f"{path}: a DNL-defined height")
    if ncomp not in (1, 3):
        raise ValueError(f"{path}: {ncomp} components (CMYK/YCCK and other "
                         f"colour spaces are not read)")
    comps = []
    for c in range(ncomp):
        cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
        comps.append((cid, hv >> 4, hv & 15, tq))
    if ncomp == 3:
        hmax = max(c[1] for c in comps)
        vmax = max(c[2] for c in comps)
        if any(c[1] not in (1, 2) or c[2] not in (1, 2)
               or hmax // c[1] * c[1] != hmax or vmax // c[2] * c[2] != vmax
               for c in comps):
            raise ValueError(f"{path}: sampling factors " + ",".join(
                f"{c[1]}x{c[2]}" for c in comps) + " (4:4:4, 4:2:2, 4:2:0 "
                "and 4:4:0 are read)")
    else:   # one component: its factors do not shape the data
        comps = [(comps[0][0], 1, 1, comps[0][3])]
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


def _sos(hdr: _Header, seg: bytes, path: str) -> None:
    if hdr.frame is None:
        raise ValueError(f"{path}: a scan before the frame header")
    comps = hdr.frame[2]
    ns = seg[0]
    if ns != len(comps):
        raise ValueError(f"{path}: a scan of {ns} of {len(comps)} "
                         f"components (multi-scan sequential)")
    ids = [c[0] for c in comps]
    scan = []
    for s in range(ns):
        cs, tables = seg[1 + 2 * s], seg[2 + 2 * s]
        if cs not in ids:
            raise ValueError(f"{path}: scan component {cs} not in the frame")
        scan.append((ids.index(cs), tables >> 4, tables & 15))
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise ValueError(f"{path}: spectral selection {ss}-{se} / "
                         f"approximation {ahal:#x} (progressive)")
    for idx, td, ta in scan:
        if td > 3 or ta > 3 or not hdr.huff_ok[0][td] \
                or not hdr.huff_ok[1][ta]:
            raise ValueError(f"{path}: a scan uses an undefined Huffman "
                             f"table")
        if not hdr.quant_ok[comps[idx][3] & 3] or comps[idx][3] > 3:
            raise ValueError(f"{path}: a component uses an undefined "
                             f"quantisation table")
    hdr.scan = scan


def _transform(hdr: _Header) -> int:
    """1 for YCbCr data, 0 for RGB data (jdapimin.c
    default_decompress_parms' guess for 3 components)."""
    if hdr.jfif:
        return 1
    if hdr.adobe_transform is not None:
        return 0 if hdr.adobe_transform == 0 else 1
    ids = [c[0] for c in hdr.frame[2]]
    return 0 if ids == [82, 71, 66] else 1


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


def decode_jpeg(data: bytes, path: str = "<bytes>",
                orientation: bool = False) -> np.ndarray:
    """[H, W] uint8 of a one-component JPEG, [H, W, 3] RGB of a
    three-component one; with ``orientation`` the EXIF orientation is
    applied as ``cv2.imread`` applies it."""
    hdr = _parse(data, path)
    height, width, comps = hdr.frame
    ncomp = len(comps)
    ints = lambda xs: np.ascontiguousarray(xs, np.int32)  # noqa: E731
    h, v, tq = (ints([c[k] for c in comps]) for k in (1, 2, 3))
    scan_comp, td, ta = (ints([s[k] for s in hdr.scan]) for k in (0, 1, 2))
    payload = np.frombuffer(data, np.uint8, len(data) - hdr.data_start,
                            hdr.data_start)
    out = np.empty((height, width, ncomp) if ncomp == 3 else (height, width),
                   np.uint8)
    arrays = [h, v, tq, hdr.quant, scan_comp, td, ta, hdr.bits[0],
              hdr.vals[0], hdr.bits[1], hdr.vals[1]]
    ptr = lambda a: a.ctypes.data_as(_p)   # noqa: E731
    err = _load().jpeg_decode_scan(
        ptr(payload), payload.size, width, height, ncomp,
        *(ptr(a) for a in arrays), hdr.restart,
        _transform(hdr) if ncomp == 3 else 0, ptr(out))
    if err:
        raise ValueError(f"{path}: {_ERRORS.get(err, f'error {err}')}")
    if orientation:
        out = apply_orientation(out, exif_orientation(hdr.exif))
    return out


def read_jpeg(path: str, orientation: bool) -> np.ndarray:
    """Decode the JPEG file at ``path`` (see :func:`decode_jpeg`)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path, orientation)
