"""Frame I/O without cv2 or imageio: 8-bit PNG decode/encode on the
standard library's ``zlib``, and ``.npy`` stacks.

The reader takes non-interlaced 8-bit grayscale, gray+alpha, RGB, RGBA
and palette images with all five PNG row filters; that covers frames and
masks as video tools write them. Anything else raises.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):  # left-dependent filters: sequential
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b, c = prev[x], prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """[H, W] or [H, W, C] uint8 array of an 8-bit PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, palette = 8, [], None
    w = h = ctype = None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
            if depth != 8 or interlace or ctype not in _CHANNELS:
                raise ValueError(f"{path}: only 8-bit non-interlaced PNGs")
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    img = img.reshape(h, w, ch)
    if ctype == 3:
        return palette[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] gray or [H, W, 3] RGB uint8 (filter 0, zlib level 6)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[2]]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                  0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def read_stack(path: str) -> np.ndarray:
    """A ``.npy`` stack, or every ``*.png`` in a directory in name order,
    as one uint8 array [N, H, W(, C)]."""
    if path.endswith(".npy"):
        return np.load(path)
    files = sorted(glob.glob(os.path.join(path, "*.png")))
    if not files:
        raise FileNotFoundError(f"no .png frames in {path}")
    return np.stack([read_png(f) for f in files])


def write_frames(outdir: str, frames: np.ndarray) -> None:
    """result.npy plus one PNG per frame under ``outdir/frames``."""
    os.makedirs(os.path.join(outdir, "frames"), exist_ok=True)
    np.save(os.path.join(outdir, "result.npy"), frames)
    for i, fr in enumerate(frames):
        write_png(os.path.join(outdir, "frames", f"{i:05d}.png"), fr)
