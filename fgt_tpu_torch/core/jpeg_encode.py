"""Baseline JPEG encoding in numpy — what the port writes its MJPG AVI
frames with (``core/video_io.write_avi``), since the card's machine has
no cv2 and no Pillow.

JFIF YCbCr (or gray), sampling 4:4:4, 4:2:2, 4:2:0 or 4:4:0 (chroma
box-averaged), libjpeg's quality-scaled Annex K quantisation tables
(``jpeg_quality_scaling``), the Annex K Huffman tables, optional restart
intervals. The DCT is the float orthonormal one, rounded; the entropy
coder and bit packing are vectorised, so an 854x480 frame takes well
under a second.

    from fgt_tpu_torch.core.jpeg_encode import encode_jpeg
    data = encode_jpeg(rgb_u8, quality=90, sampling="420")

:func:`quantized_blocks` and :func:`write_jpeg` split the two halves, and
:func:`quantize_planes` the colour conversion from the transform, so that
a caller can set planes or coefficients by hand.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1 tables, natural order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] +
    [99] * 32)

# Annex K.3 Huffman tables: (BITS[1..16], HUFFVAL)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa])

SAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2)}

_k = np.arange(8)
DCT = np.sqrt(np.where(_k == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
    (2 * _k[None] + 1) * _k[:, None] * np.pi / 16)


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling + jpeg_add_quant_table (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _plane_blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """[H, W] f64 -> [bh, bw, 8, 8], edge-replicated to bh*8 x bw*8."""
    h, w = plane.shape
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).swapaxes(1, 2)


def quantize_planes(planes, factors, tables, table_of, width: int,
                    height: int):
    """Per component its quantised DCT blocks [rows, cols, 64] (natural
    order) on the padded MCU grid: ``planes`` are the components' samples
    (already subsampled by ``factors``' (h, v)), ``table_of`` the index
    into ``tables`` of each component."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mx = -(-width // (8 * hmax))
    my = -(-height // (8 * vmax))
    blocks = []
    for plane, (h, v), t in zip(planes, factors, table_of):
        plane = np.rint(np.clip(plane, 0, 255))
        if len(planes) == 1:
            bh, bw = -(-height // 8), -(-width // 8)
        else:
            bh, bw = my * v, mx * h
        b = _plane_blocks(plane - 128, bh, bw)
        coef = DCT @ b @ DCT.T
        q = tables[t].reshape(8, 8)
        blocks.append(np.rint(coef / q).astype(np.int64).reshape(bh, bw, 64))
    return blocks


def subsample(plane: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """Box-average ``plane`` by hs x vs, the edges repeated to fill the
    last box."""
    h, w = plane.shape
    p = np.pad(plane, ((0, (-h) % vs), (0, (-w) % hs)), mode="edge")
    return p.reshape(p.shape[0] // vs, vs, p.shape[1] // hs, hs).mean(
        axis=(1, 3))


def rgb_to_ycc(img: np.ndarray):
    """JFIF's full-range Y, Cb, Cr planes (f64) of RGB samples."""
    r, g, b = (img[..., c].astype(np.float64) for c in range(3))
    return (0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128)


def quantized_blocks(img: np.ndarray, quality: int = 90,
                     sampling: str = "420"):
    """The quantised DCT blocks of ``img`` ([H, W] gray or [H, W, 3] RGB
    uint8): (per component [by, bx, 64] int in natural order, h and v
    factors per component, quantisation tables)."""
    img = np.asarray(img)
    height, width = img.shape[:2]
    if img.ndim == 2:
        planes, factors = [img.astype(np.float64)], [(1, 1)]
        tables = [quality_table(LUMA_Q, quality)]
    else:
        y, cb, cr = rgb_to_ycc(img)
        hs, vs = SAMPLING[sampling]
        planes = [y, subsample(cb, hs, vs), subsample(cr, hs, vs)]
        factors = [(hs, vs), (1, 1), (1, 1)]
        tables = [quality_table(LUMA_Q, quality),
                  quality_table(CHROMA_Q, quality)]
    return (quantize_planes(planes, factors, tables, [0, 1, 1][:len(planes)],
                            width, height), factors, tables)


def _huff_codes(spec):
    """Canonical (code, length) of each symbol of a (BITS, HUFFVAL)."""
    bits, vals = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[vals[k]] = code
            len_of[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _category(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    out = np.zeros(v.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _extra(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v < 0, v + (1 << size) - 1, v)


def _items(zz: np.ndarray, dc_diff: np.ndarray, dc_spec, ac_spec):
    """(codes, lengths, block of each item) of blocks [n, 64] in zigzag
    order, each block: its DC code and bits, then per nonzero AC the
    ZRLs, the code and the bits, then EOB unless the last is at 63."""
    n = zz.shape[0]
    dc_code, dc_len = _huff_codes(dc_spec)
    ac_code, ac_len = _huff_codes(ac_spec)
    blk, kk = np.nonzero(zz[:, 1:])
    k = kk + 1
    val = zz[blk, k]
    first = np.ones(blk.size, bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    nzrl = run // 16
    size = _category(val)
    sym = (run % 16) * 16 + size
    last = np.zeros(n, np.int64)
    np.maximum.at(last, blk, k)
    eob = last < 63
    # per block: 2 DC items, per AC nzrl + 2 items, then EOB
    per_ac = nzrl + 2
    ac_items = np.bincount(blk, weights=per_ac, minlength=n).astype(np.int64)
    counts = 2 + ac_items + eob
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    total = int(counts.sum())
    codes = np.zeros(total, np.int64)
    lens = np.zeros(total, np.int64)
    dsize = _category(dc_diff)
    codes[start] = dc_code[dsize]
    lens[start] = dc_len[dsize]
    codes[start + 1] = _extra(dc_diff, dsize)
    lens[start + 1] = dsize
    # offset of each AC's first item inside its block
    csum = np.cumsum(per_ac) - per_ac
    block_first = np.concatenate([[0], np.cumsum(
        np.bincount(blk, weights=per_ac, minlength=n).astype(np.int64))[:-1]])
    ac_at = start[blk] + 2 + csum - block_first[blk]
    zrl_at = np.repeat(ac_at, nzrl) + (
        np.arange(int(nzrl.sum())) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl))
    codes[zrl_at] = ac_code[0xF0]
    lens[zrl_at] = ac_len[0xF0]
    codes[ac_at + nzrl] = ac_code[sym]
    lens[ac_at + nzrl] = ac_len[sym]
    codes[ac_at + nzrl + 1] = _extra(val, size)
    lens[ac_at + nzrl + 1] = size
    eob_at = (start + counts - 1)[eob]
    codes[eob_at] = ac_code[0x00]
    lens[eob_at] = ac_len[0x00]
    owner = np.repeat(np.arange(n), counts)
    return codes, lens, owner


def _pack(codes: np.ndarray, lens: np.ndarray) -> bytes:
    """MSB-first bit packing, 1-padded to a byte, 0xFF stuffed."""
    total = int(lens.sum())
    if total == 0:
        return b""
    item = np.repeat(np.arange(codes.size), lens)
    starts = np.cumsum(lens) - lens
    j = np.arange(total) - starts[item]
    bits = ((codes[item] >> (lens[item] - 1 - j)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).astype(np.uint8).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def write_jpeg(blocks, factors, tables, width: int, height: int,
               restart: int = 0) -> bytes:
    """A baseline JFIF file from :func:`quantized_blocks`' output."""
    ncomp = len(blocks)
    specs = [(DC_LUMA, AC_LUMA)] + [(DC_CHROMA, AC_CHROMA)] * (ncomp - 1)
    # MCU order: per MCU, each component's h x v blocks in raster order
    if ncomp == 1:
        order = [blocks[0].reshape(-1, 64)]
        comp_of = np.zeros(order[0].shape[0], np.int64)
        mcu_of = np.arange(order[0].shape[0])
        seq = order[0]
    else:
        hmax = max(f[0] for f in factors)
        vmax = max(f[1] for f in factors)
        my = -(-height // (8 * vmax))
        mx = -(-width // (8 * hmax))
        parts, comps = [], []
        for c, (b, (h, v)) in enumerate(zip(blocks, factors)):
            m = b.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
            parts.append(m.reshape(my * mx, h * v, 64))
            comps.append(np.full(h * v, c))
        seq = np.concatenate(parts, axis=1)
        per_mcu = seq.shape[1]
        seq = seq.reshape(-1, 64)
        comp_of = np.tile(np.concatenate(comps), my * mx)
        mcu_of = np.repeat(np.arange(my * mx), per_mcu)
    zz = seq[:, ZIGZAG]
    # DC differences per component, reset at each restart interval
    interval = mcu_of // restart if restart else np.zeros_like(mcu_of)
    dc_diff = np.zeros(zz.shape[0], np.int64)
    for c in range(ncomp):
        sel = np.flatnonzero(comp_of == c)
        dc = zz[sel, 0]
        prev = np.concatenate([[0], dc[:-1]])
        new = np.concatenate([[True], interval[sel][1:] != interval[sel][:-1]])
        dc_diff[sel] = dc - np.where(new, 0, prev)
    codes = np.zeros(0, np.int64)
    lens = np.zeros(0, np.int64)
    owner = np.zeros(0, np.int64)
    for c in range(ncomp):
        sel = np.flatnonzero(comp_of == c)
        cc, ll, oo = _items(zz[sel], dc_diff[sel], *specs[c])
        codes = np.concatenate([codes, cc])
        lens = np.concatenate([lens, ll])
        owner = np.concatenate([owner, sel[oo]])
    order = np.argsort(owner, kind="stable")
    codes, lens, owner = codes[order], lens[order], owner[order]
    if restart:
        data = []
        item_interval = interval[owner]
        bounds = np.searchsorted(item_interval,
                                 np.arange(item_interval.max() + 2))
        for i in range(len(bounds) - 1):
            if i:
                data.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
            data.append(_pack(codes[bounds[i]:bounds[i + 1]],
                              lens[bounds[i]:bounds[i + 1]]))
        scan = b"".join(data)
    else:
        scan = _pack(codes, lens)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                       b"\x01\x00\x00")]
    for t, q in enumerate(tables):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            q.astype(np.uint8)[ZIGZAG].tolist())))
    comp_bytes = b"".join(bytes([c + 1, (h << 4) | v, min(c, 1)])
                          for c, (h, v) in enumerate(factors))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, ncomp)
                        + comp_bytes))
    for t, (dc, ac) in enumerate(specs[:min(ncomp, 2)]):
        for cls, (bits, vals) in ((0, dc), (1, ac)):
            out.append(_segment(0xC4, bytes([(cls << 4) | t] + bits + vals)))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    sos = bytes([ncomp]) + b"".join(
        bytes([c + 1, (min(c, 1) << 4) | min(c, 1)]) for c in range(ncomp))
    out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


def encode_jpeg(img: np.ndarray, quality: int = 90, sampling: str = "420",
                restart: int = 0) -> bytes:
    """Baseline JFIF bytes of ``img`` ([H, W] gray or [H, W, 3] RGB)."""
    blocks, factors, tables = quantized_blocks(img, quality, sampling)
    return write_jpeg(blocks, factors, tables, img.shape[1], img.shape[0],
                      restart)
