"""Canny edges of flow fields without cv2 — counterpart of
``fgt_tpu/core/edge.py``, the targets LAFC's edge loss trains against
(reference LAFC/data/train_dataset_edge.py:139-146: skimage's canny on
the flow's colour-wheel gray, ``sigma=1, low_threshold=0.1,
high_threshold=0.2``).

The JAX package computes them with cv2; the GPU machine has no cv2, so
this module rebuilds each cv2 call in numpy and scipy, to the bit where
an ulp could move an edge:

* ``cv2.cvtColor(RGB2GRAY)`` on uint8 is fixed point with 15-bit
  weights: ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``
  (:func:`rgb_to_gray_u8`);
* ``cv2.GaussianBlur`` of a float64 image: ksize ``max(3, int(4σ+1)|1)``,
  cv2's bit-exact Gaussian kernel, ``BORDER_REFLECT_101``, a row pass
  then a column pass. The row pass sums the taps in order with fused
  multiply-adds in whole groups of four columns (cv2's 4-lane double
  vectors) and with plain multiply-adds in the tail; the column pass
  adds the centre tap first, then each symmetric pair (:func:`_blur`);
* ``cv2.Sobel`` ksize 3 over reflect-101, divided by 4: every product
  is exact, so the order does not matter;
* ``cv2.connectedComponents`` with 8-connectivity:
  ``scipy.ndimage.label`` with a 3x3 structure (the labels differ, the
  components do not);
* the colour wheel: the port's ``core/flow_viz.py``, byte-equal to the
  JAX package's.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from fgt_tpu_torch.core.flow_viz import flow_to_rgb

_SPLIT = 134217729.0        # 2^27 + 1, Dekker's splitter for doubles


def rgb_to_gray_u8(rgb: np.ndarray) -> np.ndarray:
    """uint8 RGB [..., 3] -> uint8 gray, as ``cv2.cvtColor(RGB2GRAY)``."""
    v = rgb.astype(np.int32)
    return ((9798 * v[..., 0] + 19235 * v[..., 1] + 3735 * v[..., 2]
             + (1 << 14)) >> 15).astype(np.uint8)


def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(n, sigma, CV_64F)`` for odd n, sigma > 0:
    half the taps from exp, their sum doubled plus the centre's 1, each
    tap times the reciprocal of that sum."""
    half = (n - 1) // 2
    scale = -0.125 / (sigma * sigma)
    vals = [float(np.exp(float(x * x) * scale))
            for x in range(1 - n, 1 - n + 2 * half, 2)]
    total = 0.0
    for v in vals:
        total += v
    inv = 1.0 / (total * 2.0 + 1.0)
    k = np.empty(n)
    for i, v in enumerate(vals):
        k[i] = k[n - 1 - i] = v * inv
    k[half] = inv
    return k


def _fma(a, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a·b + c rounded once (error-free product and sum, then one
    rounding of their tails)."""
    p = a * b
    c_a = _SPLIT * a
    ah = c_a - (c_a - a)
    al = a - ah
    c_b = _SPLIT * b
    bh = c_b - (c_b - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    n = max(3, int(4 * sigma + 1) | 1)
    k = gaussian_kernel(n, sigma)
    r = n // 2
    h, w = img.shape
    p = np.pad(img, r, mode="reflect")          # reflect-101
    vec = (w // 4) * 4
    rows = k[0] * p[:, :w]
    for j in range(1, n):
        tap = p[:, j:j + w]
        rows = np.concatenate([_fma(k[j], tap[:, :vec], rows[:, :vec]),
                               rows[:, vec:] + k[j] * tap[:, vec:]], axis=1)
    out = k[r] * rows[r:r + h]
    for j in range(1, r + 1):
        out = out + k[r + j] * (rows[r + j:r + j + h] + rows[r - j:r - j + h])
    return out


def _sobel(img: np.ndarray):
    """(d/dx, d/dy) of ksize-3 Sobel over reflect-101, row pass first
    as cv2 runs it."""
    p = np.pad(img, 1, mode="reflect")
    rx = p[:, 2:] - p[:, :-2]                          # [-1, 0, 1]
    gx = 2 * rx[1:-1] + (rx[2:] + rx[:-2])             # [1, 2, 1]
    ry = (p[:, :-2] + 2 * p[:, 1:-1]) + p[:, 2:]       # [1, 2, 1]
    gy = ry[2:] - ry[:-2]                              # [-1, 0, 1]
    return gx, gy


def canny(image: np.ndarray, sigma: float = 1.0,
          low_threshold: float = 0.1, high_threshold: float = 0.2,
          mask: np.ndarray | None = None) -> np.ndarray:
    """Boolean edge map of a float image: gaussian smoothing, Sobel
    gradients, non-maximum suppression quantized to 4 directions, double
    threshold (absolute, on the gradient magnitude) with 8-connected
    hysteresis."""
    img = np.asarray(image, dtype=np.float64)
    smoothed = _blur(img, sigma)
    gx, gy = _sobel(smoothed)
    gx, gy = gx / 4.0, gy / 4.0
    mag = np.hypot(gx, gy)

    angle = np.mod(np.arctan2(gy, gx), np.pi)   # fold to [0, pi)
    q = ((angle + np.pi / 8) // (np.pi / 4)).astype(np.int32) % 4
    pad = np.pad(mag, 1)
    c = pad[1:-1, 1:-1]
    neighbors = [
        (pad[1:-1, 2:], pad[1:-1, :-2]),   # 0:   E / W
        (pad[2:, 2:], pad[:-2, :-2]),      # 45:  SE / NW
        (pad[2:, 1:-1], pad[:-2, 1:-1]),   # 90:  S / N
        (pad[2:, :-2], pad[:-2, 2:]),      # 135: SW / NE
    ]
    keep = np.zeros(mag.shape, dtype=bool)
    for d, (n1, n2) in enumerate(neighbors):
        keep |= (q == d) & (c >= n1) & (c >= n2)
    nms = np.where(keep, mag, 0.0)

    strong = nms >= high_threshold
    weak = nms >= low_threshold
    if mask is not None:
        strong &= mask.astype(bool)
        weak &= mask.astype(bool)
    labels, n = ndimage.label(weak, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros_like(strong)
    has_strong = np.zeros(n + 1, dtype=bool)
    has_strong[labels[strong]] = True
    has_strong[0] = False
    return has_strong[labels]


def flow_edge(flow: np.ndarray, sigma: float = 1.0,
              low_threshold: float = 0.1, high_threshold: float = 0.2):
    """(normalized magnitude, canny edge) of a flow [H, W, 2], as the
    LAFC dataset's ``load_edge`` makes them."""
    gray_flow = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    gray_flow = gray_flow / max(gray_flow.max(), 1e-8)
    rgb = flow_to_rgb(flow)
    fg = rgb_to_gray_u8((rgb * 255).astype(np.uint8)) / 255.0
    edge = canny(fg, sigma=sigma, low_threshold=low_threshold,
                 high_threshold=high_threshold).astype(np.float64)
    return gray_flow, edge
