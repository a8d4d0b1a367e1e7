"""Frame I/O without cv2 or imageio: PNG decode/encode on the standard
library's ``zlib``, JPEG decode (``core/jpeg.py``, bit-equal to
libjpeg-turbo as cv2 and imageio run it), and ``.npy`` stacks.

The PNG reader takes gray, gray+alpha, RGB, RGBA and palette images at
every bit depth PNG allows (1 to 16), interlaced or not, with all five
row filters. :func:`imread` picks PNG or JPEG by the file's signature and
returns it as ``cv2.imread`` does (``IMREAD_COLOR`` or
``IMREAD_GRAYSCALE``, EXIF orientation applied) or as ``imageio.imread``
does; what neither decoder takes raises.

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

from fgt_tpu_torch.core import jpeg

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """``h`` filtered rows of ``stride`` bytes (each after its filter-type
    byte) -> [h, stride] uint8, ``bpp`` the bytes of a whole pixel."""
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


# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, bytes] -> [h, w, ch] samples (uint8, or
    uint16 for 16-bit data; 1-, 2- and 4-bit samples unpacked)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
    return vals[:, :w * ch].astype(np.uint8).reshape(h, w, ch)


def _png_chunks(path: str):
    """(IHDR fields, inflated image bytes, PLTE palette, eXIf payload)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, palette, exif, ihdr = 8, [], None, None, None
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"eXIf":
            exif = body
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    return ihdr, zlib.decompress(b"".join(idat)), palette, exif


def _read_png(path: str):
    """(samples [H, W, C] uint8 or uint16, colour type, bit depth, PLTE,
    eXIf payload) of a PNG, Adam7 interlacing undone; palette images
    keep their indices."""
    (w, h, depth, ctype, _, _, interlace), raw, palette, exif = \
        _png_chunks(path)
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16) or \
            (ctype in (2, 4, 6) and depth < 8) or (ctype == 3 and depth > 8):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: a palette image without PLTE")
    ch = _CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-(pw * ch * depth) // 8)
        size = ph * (stride + 1)
        rows = _unfilter(raw[pos:pos + size], ph, stride, bpp)
        pos += size
        img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
    return img, ctype, depth, palette, exif


def read_png(path: str) -> np.ndarray:
    """[H, W] or [H, W, C] array of a PNG as ``imageio.imread`` (Pillow)
    returns it: palette images expanded to RGB, 1-bit gray as bool, 2-
    and 4-bit gray scaled to 8 bits, 16-bit gray as uint16, other 16-bit
    images at their high byte (gray+alpha as RGBA)."""
    img, ctype, depth, palette, _ = _read_png(path)
    if ctype == 3:
        return palette[img[..., 0]]
    if depth == 1:
        return img[..., 0].astype(bool)
    if depth < 8:
        img = img * (255 // ((1 << depth) - 1))
    elif depth == 16 and ctype != 0:
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:          # Pillow has no 16-bit LA: RGBA
            img = img[..., [0, 0, 0, 1]]
    return img[..., 0] if img.shape[2] == 1 else img


def _png_cv2(path: str, gray: bool) -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR or IMREAD_GRAYSCALE)`` of a PNG,
    as RGB: libpng expands palettes and low-bit gray, strips alpha, turns
    RGB to gray with its fixed-point (9797, 19234, 3737) / 32768 (with
    no rounding on 8-bit data, rounded on 16-bit), then keeps the high
    byte of 16-bit samples; the eXIf orientation is applied."""
    img, ctype, depth, palette, exif = _read_png(path)
    if ctype == 3:
        img = palette[img[..., 0]]
    elif depth < 8:
        img = img * (255 // ((1 << depth) - 1))
    if img.shape[2] in (2, 4):
        img = img[..., :-1]
    if gray and img.shape[2] == 3:
        x = img.astype(np.int64)
        y = 9797 * x[..., 0] + 19234 * x[..., 1] + 3737 * x[..., 2]
        img = ((y + (16384 if depth == 16 else 0)) >> 15)[..., None]
    if depth == 16:
        img = img >> 8
    img = img.astype(np.uint8)
    img = img[..., 0] if gray else np.repeat(img, 3 // img.shape[2], axis=2)
    return jpeg.apply_orientation(img, jpeg.exif_orientation(exif))


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


CLI_MODE = "color_or_unchanged"


def imread(path: str, mode: str) -> np.ndarray:
    """A PNG or JPEG file, told apart by its signature, as one of the
    reference's readers returns it: ``"color"`` — ``cv2.imread(path,
    IMREAD_COLOR)`` as RGB, [H, W, 3] uint8, EXIF orientation applied
    (the inference CLI, the dataset-preparation readers); ``"gray"`` —
    ``cv2.imread(path, IMREAD_GRAYSCALE)``, [H, W] uint8, orientation
    applied; ``"unchanged"`` — ``imageio.imread(path)``, orientation
    ignored (the datasets, validation, flow extraction, the evaluation
    ground truth); ``"color_or_unchanged"`` — the JAX CLI's ``_imread``:
    ``"color"``, or ``"unchanged"`` where cv2 gives None (a lossless gray
    JPEG, which then arrives [H, W])."""
    if mode == CLI_MODE:
        try:
            return imread(path, "color")
        except jpeg.ChannelMismatch:
            return imread(path, "unchanged")
    if mode not in jpeg.MODES:
        raise ValueError(f"mode {mode!r}: one of {jpeg.MODES + (CLI_MODE,)}")
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _SIG:
        return read_png(path) if mode == "unchanged" else \
            _png_cv2(path, mode == "gray")
    if head[:2] == jpeg.SOI:
        return jpeg.read_jpeg(path, mode)
    raise ValueError(f"{path}: not a PNG or JPEG")


def read_frames(path: str, mode: str) -> list:
    """The frames of a ``.npy`` stack, or of the ``*.png`` and ``*.jpg``
    files of a directory sorted together by name (as the JAX CLI globs
    them) and read by :func:`imread` in ``mode``, as a list of uint8
    arrays, each in its own shape."""
    if path.endswith(".npy"):
        return list(np.load(path))
    files = sorted(glob.glob(os.path.join(path, "*.png"))
                   + glob.glob(os.path.join(path, "*.jpg")))
    if not files:
        raise FileNotFoundError(f"no .png or .jpg frames in {path}")
    return [imread(f, mode) for f in files]


def read_stack(path: str, mode: str) -> np.ndarray:
    """:func:`read_frames` as one array [N, H, W(, C)]."""
    return np.stack(read_frames(path, mode))


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
