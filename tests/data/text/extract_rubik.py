"""Writes ``fgt_tpu_torch/core/fonts/Rubik.ttf.gz``: the gzip member named
``Rubik.ttf`` that OpenCV 5.0 embeds in its Python module, byte for byte
(header, deflate stream and trailer). OpenCV draws its Hershey faces
through this face; the port's ``core/text.py`` reads the copy.

The member is found by the name in its gzip header (``FNAME``), not by an
offset, so another build of the same OpenCV finds it too. Needs cv2:

    PYTHONPATH=. python tests/data/text/extract_rubik.py [OUT]
"""

from __future__ import annotations

import os
import re
import sys
import zlib

MEMBER = b"Rubik.ttf"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
OUT = os.path.join(REPO, "fgt_tpu_torch", "core", "fonts", "Rubik.ttf.gz")


def cv2_binary() -> str:
    import cv2

    here = os.path.dirname(cv2.__file__)
    names = [f for f in os.listdir(here)
             if f.startswith("cv2") and f.endswith(".so")]
    if len(names) != 1:
        raise RuntimeError(f"expected one cv2*.so in {here}, found {names}")
    return os.path.join(here, names[0])


def find_member(blob: bytes, name: bytes = MEMBER) -> bytes:
    """The whole gzip member whose header names it ``name``."""
    for m in re.finditer(rb"\x1f\x8b\x08", blob):
        start, flags = m.start(), blob[m.start() + 3]
        if not flags & 0x08:            # FNAME
            continue
        o = start + 10
        if flags & 0x04:                # FEXTRA
            o += 2 + int.from_bytes(blob[o:o + 2], "little")
        end = blob.find(b"\0", o)
        if blob[o:end] != name:
            continue
        o = end + 1
        if flags & 0x10:                # FCOMMENT
            o = blob.find(b"\0", o) + 1
        if flags & 0x02:                # FHCRC
            o += 2
        d = zlib.decompressobj(-zlib.MAX_WBITS)
        d.decompress(blob[o:])
        stop = len(blob) - len(d.unused_data) + 8   # CRC32 + ISIZE
        return blob[start:stop]
    raise LookupError(f"no gzip member named {name!r}")


def main(out: str = OUT) -> None:
    with open(cv2_binary(), "rb") as f:
        member = find_member(f.read())
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        f.write(member)
    print(f"{out}: {len(member)} bytes")


if __name__ == "__main__":
    main(*sys.argv[1:])
