"""``result.mp4`` without an encoder library — the port's counterpart of
``fgt_tpu/core/video_io.py``.

The JAX package writes its videos through imageio's ffmpeg (libx264,
lossy) or, failing that, cv2's ``mp4v``. The GPU machine has neither, so
this module writes H.264 itself, in the one form that needs no transform
and no entropy tables: every macroblock ``I_PCM`` (mb_type 25 of an I
slice), its samples stored raw. Any H.264 decoder plays it.

* Stream: Constrained Baseline profile, level 5.1 (6.2 for frames over
  5.1's 36864 macroblocks), CAVLC. Every frame is one IDR picture of
  one slice (``frame_num`` 0, ``idr_pic_id`` alternating 0 / 1,
  ``pic_order_cnt_type`` 2, no reference frames, deblocking off). A
  size that is not a multiple of 16 is coded at the next multiple, edge
  samples repeated, and cropped by the SPS (in 2-pixel units); an odd
  width or height is first made even by repeating the last column or
  row, which the file keeps.
* Samples: BT.601 limited range (Y 16-235, Cb / Cr 16-240), what a
  decoder assumes when the stream says nothing of colour; chroma is the
  mean of each 2x2 block (4:2:0). Beyond that subsampling and the
  rounding to 8 bits the file is lossless.
* Container: ISO-BMFF (``ftyp``, ``mdat``, ``moov``) with one ``avc1``
  track: an ``avcC`` box holding the SPS and PPS, 4-byte NAL lengths,
  ``stts`` at ``fps``, every sample a sync sample. ``mdat`` takes a
  64-bit size past 4 GiB; the chunk offset stays small (``stco``), as the
  samples follow ``ftyp`` in one chunk.

:func:`read_video` reads the files :func:`write_video` writes (and raises
on anything else, naming the file); :func:`read_planes` returns their
Y / Cb / Cr planes, which equal :func:`rgb_to_yuv420` of the frames
written.
"""

from __future__ import annotations

import logging
import os
import re
import struct

import numpy as np

logger = logging.getLogger("fgt_tpu_torch")

# BT.601, 8-bit limited range: [Y, Cb, Cr] = OFFSET + RGB_TO_YCC @ [R, G, B]
RGB_TO_YCC = np.array([[65.481, 128.553, 24.966],
                       [-37.797, -74.203, 112.0],
                       [112.0, -93.786, -18.214]]) / 255.0
YCC_OFFSET = np.array([16.0, 128.0, 128.0])
PROFILE_IDC, CONSTRAINT_FLAGS = 66, 0xC0      # Constrained Baseline
MB_I_PCM = 25
LOG2_MAX_FRAME_NUM = 4


# ---------------- colour ----------------

def _even(frame: np.ndarray) -> np.ndarray:
    h, w = frame.shape[:2]
    return np.pad(frame, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")


def rgb_to_yuv420(frame: np.ndarray):
    """(Y [H, W], Cb [H/2, W/2], Cr [H/2, W/2]) uint8 planes of an RGB
    uint8 frame (made even first, see the module doc): BT.601 limited
    range, chroma the mean of each 2x2 block, rounded half up."""
    rgb = _even(np.asarray(frame)).astype(np.float64)
    ycc = rgb @ RGB_TO_YCC.T + YCC_OFFSET
    h, w = ycc.shape[:2]
    y = np.clip(np.floor(ycc[..., 0] + 0.5), 16, 235).astype(np.uint8)
    c = ycc[..., 1:].reshape(h // 2, 2, w // 2, 2, 2).mean(axis=(1, 3))
    c = np.clip(np.floor(c + 0.5), 16, 240).astype(np.uint8)
    return y, c[..., 0], c[..., 1]


def _upsample2(c: np.ndarray) -> np.ndarray:
    """Chroma at 2x along both axes, each output sample 3/4 of its own
    chroma sample and 1/4 of the next one toward it (edges clamped)."""
    c = c.astype(np.float64)
    for axis in (0, 1):
        n = c.shape[axis]
        idx = np.arange(n)
        prev = np.take(c, np.maximum(idx - 1, 0), axis=axis)
        nxt = np.take(c, np.minimum(idx + 1, n - 1), axis=axis)
        out = np.stack([0.75 * c + 0.25 * prev, 0.75 * c + 0.25 * nxt],
                       axis=axis + 1)
        shape = list(c.shape)
        shape[axis] = 2 * n
        c = out.reshape(shape)
    return c


def yuv420_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                  ) -> np.ndarray:
    """RGB uint8 [H, W, 3] of BT.601 limited-range 4:2:0 planes: the
    inverse of :func:`rgb_to_yuv420`'s matrix on chroma upsampled by
    :func:`_upsample2`."""
    ycc = np.stack([y.astype(np.float64), _upsample2(cb), _upsample2(cr)],
                   axis=-1) - YCC_OFFSET
    rgb = ycc @ np.linalg.inv(RGB_TO_YCC).T
    return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)


# ---------------- H.264 ----------------

class _Bits:
    """An MSB-first bit string with Exp-Golomb codes."""

    def __init__(self):
        self.bits: list = []

    def u(self, n: int, v: int):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def ue(self, v: int):
        n = (v + 1).bit_length()
        self.u(n - 1, 0)
        self.u(n, v + 1)

    def se(self, v: int):
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align_zero(self):
        self.u(-len(self.bits) % 8, 0)

    def trailing(self):
        self.u(1, 1)
        self.align_zero()

    def bytes(self) -> bytes:
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def _nal(header: int, rbsp: bytes) -> bytes:
    """A NAL unit: header byte, then the RBSP with emulation prevention
    (``00 00 0x`` -> ``00 00 03 0x`` for x <= 3)."""
    return bytes([header]) + re.sub(b"\x00\x00(?=[\x00-\x03])",
                                    b"\x00\x00\x03", rbsp)


def _level(mbs: int) -> int:
    if mbs <= 36864:
        return 51
    if mbs <= 139264:
        return 62
    raise ValueError(f"write_video: {mbs} macroblocks a frame exceed every "
                     f"H.264 level")


def _sps(w: int, h: int) -> bytes:
    mw, mh = -(-w // 16), -(-h // 16)
    b = _Bits()
    b.u(8, PROFILE_IDC)
    b.u(8, CONSTRAINT_FLAGS)
    b.u(8, _level(mw * mh))
    b.ue(0)                                # seq_parameter_set_id
    b.ue(LOG2_MAX_FRAME_NUM - 4)
    b.ue(2)                                # pic_order_cnt_type
    b.ue(0)                                # max_num_ref_frames
    b.u(1, 0)                              # gaps_in_frame_num_allowed
    b.ue(mw - 1)
    b.ue(mh - 1)
    b.u(1, 1)                              # frame_mbs_only_flag
    b.u(1, 1)                              # direct_8x8_inference_flag
    crop_w, crop_h = 16 * mw - w, 16 * mh - h
    b.u(1, int(bool(crop_w or crop_h)))    # frame_cropping_flag
    if crop_w or crop_h:                   # offsets in 2-pixel units
        for v in (0, crop_w // 2, 0, crop_h // 2):
            b.ue(v)
    b.u(1, 0)                              # vui_parameters_present_flag
    b.trailing()
    return _nal(0x67, b.bytes())


def _pps() -> bytes:
    b = _Bits()
    b.ue(0)                                # pic_parameter_set_id
    b.ue(0)                                # seq_parameter_set_id
    b.u(1, 0)                              # entropy_coding_mode_flag: CAVLC
    b.u(1, 0)                              # bottom_field_pic_order_...
    b.ue(0)                                # num_slice_groups_minus1
    b.ue(0)                                # num_ref_idx_l0_default_...
    b.ue(0)                                # num_ref_idx_l1_default_...
    b.u(1, 0)                              # weighted_pred_flag
    b.u(2, 0)                              # weighted_bipred_idc
    b.se(0)                                # pic_init_qp_minus26
    b.se(0)                                # pic_init_qs_minus26
    b.se(0)                                # chroma_qp_index_offset
    b.u(1, 1)                              # deblocking_filter_control_...
    b.u(1, 0)                              # constrained_intra_pred_flag
    b.u(1, 0)                              # redundant_pic_cnt_present_flag
    b.trailing()
    return _nal(0x68, b.bytes())


def _mb_type_bytes() -> bytes:
    """mb_type I_PCM, then the pcm alignment bits, from a byte boundary:
    every macroblock after the first starts with these bytes."""
    b = _Bits()
    b.ue(MB_I_PCM)
    b.align_zero()
    return b.bytes()


def _slice(planes, idr_pic_id: int) -> bytes:
    """One IDR slice of I_PCM macroblocks from padded planes (Y a
    multiple of 16 in both axes)."""
    y, cb, cr = planes
    mh, mw = y.shape[0] // 16, y.shape[1] // 16
    blocks = np.concatenate([
        y.reshape(mh, 16, mw, 16).transpose(0, 2, 1, 3).reshape(-1, 256),
        cb.reshape(mh, 8, mw, 8).transpose(0, 2, 1, 3).reshape(-1, 64),
        cr.reshape(mh, 8, mw, 8).transpose(0, 2, 1, 3).reshape(-1, 64)],
        axis=1)
    b = _Bits()
    b.ue(0)                                # first_mb_in_slice
    b.ue(7)                                # slice_type: I, all slices
    b.ue(0)                                # pic_parameter_set_id
    b.u(LOG2_MAX_FRAME_NUM, 0)             # frame_num
    b.ue(idr_pic_id)
    b.u(1, 0)                              # no_output_of_prior_pics_flag
    b.u(1, 0)                              # long_term_reference_flag
    b.se(0)                                # slice_qp_delta
    b.ue(1)                                # disable_deblocking_filter_idc
    b.ue(MB_I_PCM)                         # the first macroblock's type
    b.align_zero()
    head = np.frombuffer(_mb_type_bytes(), np.uint8)
    rest = np.concatenate([np.broadcast_to(head, (len(blocks) - 1, 2)),
                           blocks[1:]], axis=1)
    rbsp = b"".join((b.bytes(), blocks[0].tobytes(), rest.tobytes(),
                     b"\x80"))             # rbsp_slice_trailing_bits
    return _nal(0x65, rbsp)


def _pad16(planes):
    y, cb, cr = planes
    ph, pw = -y.shape[0] % 16, -y.shape[1] % 16
    return (np.pad(y, ((0, ph), (0, pw)), mode="edge"),
            np.pad(cb, ((0, ph // 2), (0, pw // 2)), mode="edge"),
            np.pad(cr, ((0, ph // 2), (0, pw // 2)), mode="edge"))


# ---------------- ISO-BMFF ----------------

def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _moov(w: int, h: int, sps: bytes, pps: bytes, sizes: list,
          offset: int, fps: float) -> bytes:
    n = len(sizes)
    timescale, delta = int(round(fps * 1000)), 1000
    movie_duration = int(round(n * 1000 / fps))
    avcc = _box(b"avcC", bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]),
                struct.pack(">H", len(sps)), sps, b"\x01",
                struct.pack(">H", len(pps)), pps)
    name = b"fgt_tpu_torch I_PCM"
    avc1 = _box(b"avc1", bytes(6), struct.pack(">H", 1), bytes(16),
                struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1),
                bytes([len(name)]) + name + bytes(31 - len(name)),
                struct.pack(">Hh", 0x18, -1), avcc)
    stbl = _box(
        b"stbl",
        _full(b"stsd", 0, 0, struct.pack(">I", 1), avc1),
        _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
        _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1)),
        _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
        _full(b"stco", 0, 0, struct.pack(">II", 1, offset)))
    minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)),
                _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                    _full(b"url ", 0, 1))), stbl)
    mdia = _box(
        b"mdia",
        _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale,
                                          n * delta, 0x55C4, 0)),
        _full(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12),
              b"VideoHandler\x00"), minf)
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0,
                                            movie_duration), bytes(8),
                 struct.pack(">hhhH", 0, 0, 0, 0), MATRIX,
                 struct.pack(">II", w << 16, h << 16))
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, 1000,
                                            movie_duration, 0x10000, 0x100),
                 bytes(10), MATRIX, bytes(24), struct.pack(">I", 2))
    return _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))


def write_video(path: str, frames, fps: float = 30) -> None:
    """RGB uint8 frames ([N, H, W, 3] or a list of [H, W, 3]) as an
    H.264 I_PCM ``.mp4`` at ``fps`` (see the module doc), written to a
    temporary file renamed into place."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError(f"write_video: no frames for {path}")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"write_video: {path}: every frame must be "
                             f"uint8 [{h}, {w}, 3], got {f.dtype} "
                             f"{list(f.shape)}")
    if h % 2 or w % 2:
        logger.warning("write_video: %s: %dx%d is not even; the file holds "
                       "%dx%d, the last row / column repeated", path, w, h,
                       w + w % 2, h + h % 2)
        h, w = h + h % 2, w + w % 2
    sps, pps = _sps(w, h), _pps()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512),
                b"isomiso2avc1mp41")
    sizes = []
    with open(tmp, "wb") as f:
        # a "wide" box ahead of mdat turns into its 64-bit size if needed
        f.write(ftyp + _box(b"wide") + struct.pack(">I", 0) + b"mdat")
        offset = f.tell()
        for i, frame in enumerate(frames):
            nal = _slice(_pad16(rgb_to_yuv420(frame)), i % 2)
            f.write(struct.pack(">I", len(nal)) + nal)
            sizes.append(4 + len(nal))
        end = f.tell()
        f.write(_moov(w, h, sps, pps, sizes, offset, fps))
        f.seek(len(ftyp))
        if end - offset + 8 < 2 ** 32:
            f.write(_box(b"wide") + struct.pack(">I", end - offset + 8)
                    + b"mdat")
        else:
            f.write(struct.pack(">I", 1) + b"mdat"
                    + struct.pack(">Q", end - offset + 16))
    os.replace(tmp, path)


# ---------------- reading back ----------------

class _BitReader:
    def __init__(self, data: bytes, fail):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos, self.fail = 0, fail

    def u(self, n: int) -> int:
        if self.pos + n > len(self.bits):
            self.fail("truncated header")
        v = 0
        for bit in self.bits[self.pos:self.pos + n]:
            v = (v << 1) | int(bit)
        self.pos += n
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                self.fail("bad Exp-Golomb code")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def _boxes(data: bytes, start: int, end: int, fail) -> dict:
    """{kind: (payload start, payload end)} of the boxes in
    ``data[start:end]`` (the first of each kind)."""
    out, pos = {}, start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            size, head = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            fail(f"box {kind!r} overruns its parent")
        out.setdefault(kind, (pos + head, pos + size))
        pos += size
    return out


def _unescape(nal: bytes) -> bytes:
    return re.sub(b"\x00\x00\x03", b"\x00\x00", nal)


def read_planes(path: str) -> list:
    """The (Y, Cb, Cr) uint8 planes of every frame of an ``.mp4``
    written by :func:`write_video`, cropped as its SPS says. Anything
    else raises ``ValueError`` naming the file."""
    def fail(why):
        raise ValueError(f"read_video: {path}: {why} (only the H.264 I_PCM "
                         f"files write_video writes are read)")

    with open(path, "rb") as f:
        data = f.read()
    top = _boxes(data, 0, len(data), fail)
    if b"moov" not in top or b"mdat" not in top:
        fail("no moov or mdat box")
    box = top[b"moov"]
    for kind in (b"trak", b"mdia", b"minf", b"stbl"):
        inner = _boxes(data, *box, fail)
        if kind not in inner:
            fail(f"no {kind.decode()} box")
        box = inner[kind]
    stbl = _boxes(data, *box, fail)
    for kind in (b"stsd", b"stsz", b"stsc", b"stco"):
        if kind not in stbl:
            fail(f"no {kind.decode()} box")
    lo, hi = stbl[b"stsd"]
    entry = _boxes(data, lo + 8, hi, fail)
    if b"avc1" not in entry:
        fail("the track is not avc1")
    lo, hi = entry[b"avc1"]
    avcc = _boxes(data, lo + 78, hi, fail)
    if b"avcC" not in avcc:
        fail("no avcC box")
    lo, _ = avcc[b"avcC"]
    if data[lo + 4] & 3 != 3 or data[lo + 5] & 0x1F != 1:
        fail("avcC must hold 4-byte NAL lengths and one SPS")
    n_sps = struct.unpack(">H", data[lo + 6:lo + 8])[0]
    sps = _unescape(data[lo + 8:lo + 8 + n_sps])
    lo, _ = stbl[b"stsz"]
    fixed, n = struct.unpack(">II", data[lo + 4:lo + 12])
    sizes = ([fixed] * n if fixed else
             list(struct.unpack(f">{n}I", data[lo + 12:lo + 12 + 4 * n])))
    lo, _ = stbl[b"stsc"]
    if struct.unpack(">I", data[lo + 4:lo + 8])[0] != 1 or \
            struct.unpack(">III", data[lo + 8:lo + 20])[1] != n:
        fail("the samples must lie in one chunk")
    lo, _ = stbl[b"stco"]
    offset = struct.unpack(">I", data[lo + 8:lo + 12])[0]

    bits = _BitReader(sps[1:], fail)
    if sps[0] & 0x1F != 7 or bits.u(8) != PROFILE_IDC:
        fail("the SPS is not Baseline")
    bits.u(16)                             # constraint flags, level
    sps_fields = [bits.ue(), bits.ue(), bits.ue(), bits.ue(), bits.u(1)]
    if sps_fields != [0, LOG2_MAX_FRAME_NUM - 4, 2, 0, 0]:
        fail(f"unexpected SPS fields {sps_fields}")
    mw, mh = bits.ue() + 1, bits.ue() + 1
    if bits.u(1) != 1:
        fail("field coding")
    bits.u(1)
    crop = [bits.ue() for _ in range(4)] if bits.u(1) else [0, 0, 0, 0]
    w, h = 16 * mw - 2 * (crop[0] + crop[1]), 16 * mh - 2 * (crop[2]
                                                             + crop[3])
    n_mb = mw * mh
    head = np.frombuffer(_mb_type_bytes(), np.uint8)
    out, pos = [], offset
    for size in sizes:
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        if length + 4 != size:
            fail("a sample holds more than one NAL unit")
        nal = _unescape(data[pos + 4:pos + 4 + length])
        pos += size
        if nal[0] & 0x1F != 5:
            fail(f"NAL unit type {nal[0] & 0x1F} is not an IDR slice")
        bits = _BitReader(nal[1:64], fail)
        hdr = [bits.ue(), bits.ue(), bits.ue(), bits.u(LOG2_MAX_FRAME_NUM)]
        if hdr[0] != 0 or hdr[1] not in (2, 7) or hdr[3] != 0:
            fail(f"unexpected slice header {hdr}")
        bits.ue()                          # idr_pic_id
        bits.u(2)                          # dec_ref_pic_marking
        bits.se()                          # slice_qp_delta
        if bits.ue() != 1:
            fail("deblocking is on")
        if bits.ue() != MB_I_PCM:
            fail("a macroblock is not I_PCM")
        start = 1 + -(-bits.pos // 8)
        body = np.frombuffer(nal, np.uint8, count=len(nal) - start - 1,
                             offset=start)
        if len(body) != 384 + (n_mb - 1) * 386 or nal[-1] != 0x80:
            fail("the slice is not one picture of I_PCM macroblocks")
        rest = body[384:].reshape(n_mb - 1, 386)
        if not (rest[:, :2] == head).all():
            fail("a macroblock is not I_PCM")
        blocks = np.concatenate([body[:384][None], rest[:, 2:]])
        y = blocks[:, :256].reshape(mh, mw, 16, 16).transpose(0, 2, 1, 3)
        cb = blocks[:, 256:320].reshape(mh, mw, 8, 8).transpose(0, 2, 1, 3)
        cr = blocks[:, 320:].reshape(mh, mw, 8, 8).transpose(0, 2, 1, 3)
        out.append((y.reshape(16 * mh, 16 * mw)[:h, :w],
                    cb.reshape(8 * mh, 8 * mw)[:h // 2, :w // 2],
                    cr.reshape(8 * mh, 8 * mw)[:h // 2, :w // 2]))
    return out


def read_video(path: str) -> list:
    """RGB uint8 frames of an ``.mp4`` written by :func:`write_video`
    (:func:`read_planes` through :func:`yuv420_to_rgb`)."""
    return [yuv420_to_rgb(*planes) for planes in read_planes(path)]
