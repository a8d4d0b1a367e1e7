"""Frame I/O without cv2 or imageio: 8-bit PNG decode/encode on the
standard library's ``zlib``, and ``.npy`` stacks.

The reader takes non-interlaced 8-bit grayscale, gray+alpha, RGB, RGBA
and palette images with all five PNG row filters; that covers frames and
masks as video tools write them. Anything else raises (JPEG included:
the GPU machine has no decoder for it).

:func:`resize_linear` and :func:`resize_nearest` reproduce cv2's
``INTER_LINEAR`` (on float32 frames and flows) and ``INTER_NEAREST``
resizes, so the port's frames, flows and masks match the JAX package's
loaders (bit for bit at the sizes ``tests/test_torch_port_data.py``
lists; the few large upscales of 3- and 4-channel images it names sit
one ulp away); :func:`resize_linear_u8` reproduces ``INTER_LINEAR`` on
uint8 frames, which cv2 computes in fixed point (the evaluation tool's
ground truth and the training datasets' frames).
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


def _linear_taps(src: int, dst: int):
    """INTER_LINEAR source indices and fractions along one axis as cv2's
    1-, 3- and 4-channel float path takes them: the position in f64, its
    fraction stored in f32, both taps clamped to the edge."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = (pos - i0).astype(np.float32)
    frac[i0 < 0] = 0
    i0 = np.maximum(i0, 0)
    edge = i0 >= src - 1
    frac[edge] = 0
    i0[edge] = src - 1
    return i0, np.minimum(i0 + 1, src - 1), frac


def lerp_f32(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """fma(b - a, t, a) in f32, the arithmetic of cv2's float resize and
    remap (the product of two f32 values is exact in f64)."""
    return ((b - a).astype(np.float64) * t + a).astype(np.float32)


def _generic_taps(src: int, dst: int):
    """cv2's generic INTER_LINEAR taps along one axis: the position
    (x + 0.5) · (1 / (dst / src)) - 0.5 rounded to f32, its fraction
    taken in f32, the weights (1 - f, f). Returns the two source
    indices, clipped to the image, the two weights, and where the
    position lies outside [0, src - 1)."""
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(
        np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(np.float32)
    outside = (i0 < 0) | (i0 >= src - 1)
    return (np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1),
            np.float32(1) - frac, frac, outside)


def _resize_generic(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize's own INTER_LINEAR on one float32 [H, W, C] image, as
    it runs for 2 channels (flows): columns then rows, each a0·S0 + a1·S1
    in f32 with no fused multiply-add. Along x a position outside the
    image takes the edge pixel; along y only the row indices are clipped,
    the weights stay. An exact 2x downscale is cv2's area-fast path:
    ((S00 + S01) + S10) + S11, times 0.25."""
    H, W = img.shape[:2]
    if (H, W) == (2 * h, 2 * w):
        return (((img[0::2, 0::2] + img[0::2, 1::2]) + img[1::2, 0::2])
                + img[1::2, 1::2]) * np.float32(0.25)
    x0, x1, a0, a1, x_out = _generic_taps(W, w)
    y0, y1, b0, b1, _ = _generic_taps(H, h)
    rows = img[:, x0] * a0[:, None] + img[:, x1] * a1[:, None]
    rows[:, x_out] = img[:, x0[x_out]]
    return rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]


def resize_linear(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """[N, H, W(, C)] frames -> [N, h, w(, C)] float32 with cv2.resize
    ``INTER_LINEAR`` on float32 input. cv2 takes two routes: 1, 3 and 4
    channels go through its IPP layer (rows first, then columns, each a
    lerp with a fused multiply-add); other channel counts, flows among
    them, through :func:`_resize_generic`."""
    frames = np.asarray(frames, np.float32)
    if frames.shape[1:3] == (h, w):
        return frames.copy()
    channels = frames.shape[3] if frames.ndim == 4 else 1
    if channels not in (1, 3, 4):
        return np.stack([_resize_generic(fr, h, w) for fr in frames])
    x0, x1, fx = _linear_taps(frames.shape[2], w)
    y0, y1, fy = _linear_taps(frames.shape[1], h)
    out = np.empty((frames.shape[0], h, w) + frames.shape[3:], np.float32)
    ex = (slice(None),) + (None,) * (frames.ndim - 3)
    for i, fr in enumerate(frames):
        rows = lerp_f32(fr[:, x0], fr[:, x1], fx[ex])
        out[i] = lerp_f32(rows[y0], rows[y1],
                          fy[(slice(None), None) + ex[1:]])
    return out


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2's INTER_NEAREST source index along one axis:
    floor(x · (1 / (dst / src))), clamped to src - 1. The reciprocal of
    the reciprocal matters: floor(x · src / dst) picks another pixel
    wherever x · src / dst is whole and cv2's product rounds below it."""
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src)))
                      .astype(np.int64), src - 1)


def resize_nearest(masks: np.ndarray, h: int, w: int) -> np.ndarray:
    """[N, H, W(, C)] -> [N, h, w(, C)] with cv2 ``INTER_NEAREST``."""
    if masks.shape[1:3] == (h, w):
        return masks
    return masks[:, _nearest_index(masks.shape[1], h)][
        :, :, _nearest_index(masks.shape[2], w)]


def _linear_taps_u8(src: int, dst: int):
    """cv2's fixed-point INTER_LINEAR taps along one axis: the position
    rounded to f32, its fraction taken in f32, and the two weights
    (1 - f, f) each rounded to 11 fractional bits (to even)."""
    pos = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(
        np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(np.float32)
    return (i0, np.rint((np.float32(1) - frac) * np.float32(2048)).astype(
        np.int64), np.rint(frac * np.float32(2048)).astype(np.int64))


def resize_linear_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """[H, W] or [H, W, C] uint8 -> [h, w(, C)] uint8, bit-equal to
    ``cv2.resize(img, (w, h))`` (``INTER_LINEAR`` on uint8): columns
    first in integers (weights of 2048), then rows as cv2's vector
    path computes them, ((S0 >> 4)·b0 >> 16) + ((S1 >> 4)·b1 >> 16),
    rounded off by two bits and saturated."""
    img = np.asarray(img, np.uint8)
    H, W = img.shape[:2]
    if (H, W) == (h, w):
        return img.copy()
    x0, a0, a1 = _linear_taps_u8(W, w)
    outside = (x0 < 0) | (x0 >= W - 1)       # the edge pixel, weight 2048
    a0[outside], a1[outside] = 2048, 0
    x0 = np.clip(x0, 0, W - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y0, b0, b1 = _linear_taps_u8(H, h)
    y1 = np.clip(y0 + 1, 0, H - 1)
    y0 = np.clip(y0, 0, H - 1)
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[ex] + src[:, x1] * a1[ex]
    ey = (slice(None), None) + (None,) * (img.ndim - 2)
    out = (((rows[y0] >> 4) * b0[ey] >> 16) + ((rows[y1] >> 4) * b1[ey] >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
