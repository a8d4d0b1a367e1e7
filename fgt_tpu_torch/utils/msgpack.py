"""The JAX package's weight files without flax or msgpack: a MessagePack
codec in plain Python and numpy with flax's conventions
(``flax.serialization.msgpack_serialize`` / ``msgpack_restore``).

flax writes a tree of dicts (string keys) whose leaves are arrays,
numpy scalars, Python scalars, strings and bytes:

* an array is ext type 1, holding the msgpack array ``(shape, dtype
  name, C-order bytes)``; a numpy scalar is ext type 3, the same payload
  of a 0-d array;
* an array of more than ``MAX_CHUNK_SIZE`` bytes that is a dict value (or
  the whole tree) is written as ``{"__msgpack_chunked_array__": True,
  "shape": {"0": d0, ...}, "chunks": {"0": flat part, ...}}``, which
  :func:`unpack` joins back into one array.

``bfloat16`` leaves read as ``torch.bfloat16`` tensors (numpy has no
bfloat16; a bfloat16 numpy scalar reads as a 0-d tensor, which
:func:`pack` writes back as a 0-d array); every other array reads as a
read-only numpy view of the file's bytes. Python complex numbers (ext
type 2) and unknown ext codes raise ``ValueError``. :func:`pack` writes the bytes flax writes for trees
of dicts, lists, numpy arrays (and bfloat16 tensors) and Python scalars,
its dict keys sorted as flax's copy of the tree sorts them.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30          # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_NPSCALAR = 1, 3     # flax's ext codes (2: a Python complex)
CHUNKED = "__msgpack_chunked_array__"


# ---------------- decoding ----------------

class _Reader:
    """One msgpack value after another from ``buf`` (a memoryview)."""

    def __init__(self, buf: memoryview, name: str):
        self.buf, self.pos, self.name = buf, 0, name

    def fail(self, why: str):
        raise ValueError(f"msgpack: {why} at byte {self.pos} of {self.name}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            self.fail("truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(">" + "BHI"[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(">" + "BHI"[b - 0xC7]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.text(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            n = self.unpack(">" + "HI"[b - 0xDC])
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.mapping(self.unpack(">" + "HI"[b - 0xDE]))
        self.fail(f"unknown format byte 0x{b:02x}")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, memoryview):
                key = bytes(key)
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            self.fail(f"ext type {code} is not read (flax's ndarray is 1 "
                      f"and its numpy scalar 3; 2, a Python complex, has no "
                      f"place in a weight file)")
        inner = _Reader(data, f"the ext {code} payload in {self.name}")
        shape, dtype, raw = inner.value()
        if inner.pos != len(data) or not isinstance(raw, memoryview):
            self.fail(f"malformed ext {code} payload")
        arr = _array(raw, dtype, tuple(shape), self.fail)
        if code == EXT_NPSCALAR:
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        return arr


def _array(raw: memoryview, dtype: str, shape: tuple, fail):
    if dtype == "bfloat16":
        bits = np.frombuffer(raw, np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    try:
        dt = np.dtype(dtype)
    except TypeError:
        fail(f"unknown dtype {dtype!r}")
    if dt.hasobject or dt.fields is not None:
        fail(f"dtype {dtype!r} is not read")
    return np.frombuffer(raw, dt).reshape(shape)


def _bytes_out(tree):
    """Replace the reader's memoryviews (msgpack bin) by bytes."""
    if isinstance(tree, memoryview):
        return bytes(tree)
    if isinstance(tree, dict):
        return {k: _bytes_out(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bytes_out(v) for v in tree]
    return tree


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked leaves (the tree
    itself or dict values, at any dict depth) joined into arrays."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpack(data, name: str = "the data"):
    """The tree ``flax.serialization.msgpack_restore(data)`` returns (see
    the module doc for bfloat16 and the refused ext types). ``name``
    labels errors."""
    reader = _Reader(memoryview(data).cast("B"), name)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        reader.fail("trailing bytes after the top-level value")
    return _unchunk(_bytes_out(tree))


# ---------------- encoding ----------------

def _head(out: list, n: int, fix: int, fix_max: int, codes: tuple,
          widths: str):
    if n <= fix_max:
        out.append(bytes([fix | n]))
        return
    for code, w in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(w)):
            out.append(bytes([code]) + struct.pack(">" + w, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _int(out: list, x: int):
    if 0 <= x < 0x80:
        out.append(bytes([x]))
    elif -32 <= x < 0:
        out.append(bytes([x & 0xFF]))
    elif 0 <= x <= 0xFF:
        out.append(b"\xcc" + struct.pack(">B", x))
    elif -0x80 <= x < 0:
        out.append(b"\xd0" + struct.pack(">b", x))
    elif 0 <= x <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", x))
    elif -0x8000 <= x < 0:
        out.append(b"\xd1" + struct.pack(">h", x))
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", x))
    elif -0x80000000 <= x < 0:
        out.append(b"\xd2" + struct.pack(">i", x))
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", x))
    elif -0x8000000000000000 <= x < 0:
        out.append(b"\xd3" + struct.pack(">q", x))
    else:
        raise ValueError(f"msgpack: integer {x} out of range")


def _bin(out: list, b: bytes):
    n = len(b)
    for code, w in ((0xC4, "B"), (0xC5, "H"), (0xC6, "I")):
        if n < 1 << (8 * struct.calcsize(w)):
            out.append(bytes([code]) + struct.pack(">" + w, n))
            out.append(b)
            return
    raise ValueError(f"msgpack: {n} bytes too large for one bin")


def _ext(out: list, code: int, payload: bytes):
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]) + struct.pack(">b", code))
    else:
        for head, w in ((0xC7, "B"), (0xC8, "H"), (0xC9, "I")):
            if n < 1 << (8 * struct.calcsize(w)):
                out.append(bytes([head]) + struct.pack(">" + w + "b", n,
                                                       code))
                break
        else:
            raise ValueError(f"msgpack: ext of {n} bytes too large")
    out.append(payload)


def _array_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: (shape, dtype name, C bytes)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = tuple(t.shape), "bfloat16"
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise ValueError("msgpack: object and structured dtypes are "
                             "not written")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    out: list = []
    _head(out, 3, 0x90, 15, (0xDC, 0xDD), "HI")
    _head(out, len(shape), 0x90, 15, (0xDC, 0xDD), "HI")
    for d in shape:
        _int(out, int(d))
    _str(out, name)
    _bin(out, raw)
    return b"".join(out)


def _str(out: list, s: str):
    b = s.encode("utf-8")
    _head(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), "BHI")
    out.append(b)


def _chunk(arr, max_chunk: int):
    """flax's ``_chunk``: a flat array cut into parts of at most
    ``max_chunk`` bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else arr.dtype.itemsize
    size = max(1, int(max_chunk / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[lo:lo + size]
                       for i, lo in enumerate(range(0, n, size))}}


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk_leaves(tree, max_chunk: int):
    """flax's ``_chunk_array_leaves_in_place``: big arrays that are dict
    values (at any dict depth) or the whole tree."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v, max_chunk) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)) \
            and _nbytes(tree) > max_chunk:
        return _chunk(tree, max_chunk)
    return tree


def _pack(out: list, x):
    if x is None:
        out.append(b"\xc0")
    elif type(x) is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _str(out, x)
    elif type(x) is bytes:
        _bin(out, x)
    elif type(x) is list:
        _head(out, len(x), 0x90, 15, (0xDC, 0xDD), "HI")
        for v in x:
            _pack(out, v)
    elif type(x) is dict:
        _head(out, len(x), 0x80, 15, (0xDE, 0xDF), "HI")
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    else:
        raise TypeError(f"msgpack: cannot write {type(x).__name__}")


def _sorted(tree):
    """The tree with every dict's keys in sorted order, as flax's copy of
    the tree (``jax.tree_util.tree_map``) orders them before packing."""
    if type(tree) is dict:
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if type(tree) is list:
        return [_sorted(v) for v in tree]
    return tree


def pack(tree, max_chunk: int = MAX_CHUNK_SIZE) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree)`` for a
    tree of dicts, lists, numpy arrays, numpy scalars, bfloat16 (or other)
    torch tensors, bytes and Python scalars: dict keys sorted, arrays
    over ``max_chunk`` bytes chunked as flax chunks them at its
    ``MAX_CHUNK_SIZE``."""
    out: list = []
    _pack(out, _chunk_leaves(_sorted(tree), max_chunk))
    return b"".join(out)
