"""Middlebury ``.flo`` optical-flow files — the port's own copy of
``read_flow``/``write_flow`` in ``fgt_tpu/core/flow_io.py`` (reference
RAFT/utils/frame_utils.py:12-36): little-endian float32 magic
``202021.25``, int32 width, int32 height, then H·W·2 float32 (u, v) per
pixel.
"""

from __future__ import annotations

import numpy as np

TAG_FLOAT = 202021.25


def read_flow(path: str) -> np.ndarray:
    """Read a .flo file into an ``[H, W, 2]`` float32 array."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or abs(float(magic[0]) - TAG_FLOAT) > 1e-3:
            raise ValueError(f"{path}: invalid .flo magic {magic!r}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
        if data.size != 2 * w * h:
            raise ValueError(f"{path}: truncated .flo ({data.size} values, "
                             f"want {2 * w * h})")
    return data.reshape(h, w, 2)


def write_flow(flow: np.ndarray, path: str) -> None:
    """Write an ``[H, W, 2]`` array to a .flo file."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([TAG_FLOAT], dtype=np.float32).tofile(f)
        np.array([w, h], dtype=np.int32).tofile(f)
        flow.tofile(f)
