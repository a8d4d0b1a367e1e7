"""cv2-free twins of the drawing and resampling calls that
``core/masks.py`` makes, each bit-equal to OpenCV's on uint8 images
(``tests/test_torch_port_masks.py``):

* :func:`fill_poly` — ``cv2.fillPoly(img, [pts], color)`` on int32
  points (8-connected, no shift): every edge drawn as a Bresenham line,
  then the even-odd scanline fill of cv2's edge collection in 16-bit
  fixed point;
* :func:`fill_ellipse` — ``cv2.ellipse(img, center, axes, 0, 0, 360,
  color, -1)``: cv2's polygon of the ellipse (its degree sine table),
  filled as a convex polygon;
* :func:`rotation_matrix_2d` and :func:`warp_affine_nearest` —
  ``cv2.getRotationMatrix2D`` and ``cv2.warpAffine(..., INTER_NEAREST)``
  with a zero border, in f32 with cv2's fused multiply-add;
* ``INTER_NEAREST`` resizes are ``pipeline.image_io.resize_nearest``.
"""

from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _line_pixels(x0: int, y0: int, x1: int, y1: int):
    """The pixels of cv2's 8-connected ``LineIterator`` from (x0, y0) to
    (x1, y1), walked left to right: a step along the major axis every
    pixel and along the minor one while the error term is negative,
    which is minor_k = ceil((2·dmin·k - dmaj) / (2·dmaj))."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    dmaj, dmin = (dy, dx) if vert else (dx, dy)
    k = np.arange(dmaj + 1, dtype=np.int64)
    minor = -((dmaj - 2 * dmin * k) // (2 * dmaj)) if dmaj else k
    if vert:
        return x0 + minor, y0 + sy * k
    return x0 + k, y0 + sy * minor


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    h, w = img.shape[:2]
    coords = (int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1]))
    if min(coords) < 0 or max(coords[0], coords[2]) >= w or \
            max(coords[1], coords[3]) >= h:
        raise ValueError("fill_poly: points must lie inside the image")
    xs, ys = _line_pixels(*coords)
    img[ys, xs] = color


def _hlines(img: np.ndarray, ys, x1, x2, color) -> None:
    """Fill [x1, x2] on each row ys (clipped; empty spans skipped)."""
    w = img.shape[1]
    keep = (x1 < w) & (x2 >= 0) & (x2 >= x1) & (ys >= 0) & \
        (ys < img.shape[0])
    ys, x1, x2 = ys[keep], np.maximum(x1[keep], 0), np.minimum(x2[keep],
                                                               w - 1)
    diff = np.zeros((img.shape[0], w + 1), np.int32)
    np.add.at(diff, (ys, x1), 1)
    np.add.at(diff, (ys, x2 + 1), -1)
    img[np.cumsum(diff[:, :w], axis=1) > 0] = color


def fill_poly(img: np.ndarray, pts: np.ndarray, color: int = 255) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], color)`` on a 2-D uint8 ``img`` (in
    place; returned), ``pts`` [N, 2] int (x, y) inside the image.

    cv2's ``CollectPolyEdges`` draws each edge as a line and keeps each
    non-horizontal edge as (y0, y1, x, dx): x the upper end in 16-bit
    fixed point, dx = ((x1 - x0) << 16) / (y1 - y0) truncated toward
    zero. ``FillEdgeCollection`` then walks rows y0 <= y < y1 of the
    active edges, sorts their x, and fills each pair's
    [(x_left + ½) >> 16, x_right >> 16]."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    n = len(pts)
    prev = np.roll(pts, 1, axis=0)             # edge i runs pts[i-1] -> pts[i]
    for a, b in zip(prev, pts):
        _draw_line(img, a, b, color)
    ys_a, ys_b = prev[:, 1], pts[:, 1]
    keep = ys_a != ys_b
    if n < 2 or keep.sum() < 2:
        return img
    xa = prev[keep, 0] << XY_SHIFT
    xb = pts[keep, 0] << XY_SHIFT
    ya, yb = ys_a[keep], ys_b[keep]
    num, den = xb - xa, yb - ya
    dx = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))
    down = ya < yb
    y0 = np.where(down, ya, yb)
    y1 = np.where(down, yb, ya)
    x0 = np.where(down, xa, xb)
    rows = y1 - y0
    edge = np.repeat(np.arange(len(y0)), rows)
    step = np.arange(rows.sum()) - np.repeat(np.cumsum(rows) - rows, rows)
    ys = y0[edge] + step
    xs = x0[edge] + step * dx[edge]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    left, right = xs[0::2], xs[1::2]
    _hlines(img, ys[0::2], (left + (XY_ONE >> 1)) >> XY_SHIFT,
            right >> XY_SHIFT, color)
    return img


# cv2's sine table (drawing.cpp SinTable): sin of each whole degree
# 0..450, written to 7 decimals and stored as float32
_SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(
    np.float32)


def _ellipse_points(center, axes, delta: int) -> np.ndarray:
    """cv2's ``ellipse2Poly`` of a full ellipse at angle 0 (cos 1, sin 0)
    on fixed-point center and axes: a point every ``delta`` degrees from
    the sine table, rounded half to even as ``EllipseEx`` rounds it,
    consecutive duplicates dropped."""
    cx, cy = (float(c) for c in center)
    ax, ay = (float(a) for a in axes)
    pts = []
    for i in range(0, 360 + delta, delta):
        angle = min(i, 360)
        p = (int(np.rint(cx + ax * np.float64(_SIN_TABLE[450 - angle]))),
             int(np.rint(cy + ay * np.float64(_SIN_TABLE[angle]))))
        if not pts or p != pts[-1]:
            pts.append(p)
    if len(pts) == 1:
        pts = [pts[0], pts[0]]
    return np.asarray(pts, np.int64)


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """cv2's ``Line2``: a line between fixed-point (16-bit) points."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = (int(v) for v in p1), (int(v) for v in p2)
    if not (0 <= min(x1, x2) and max(x1, x2) < (w << XY_SHIFT)
            and 0 <= min(y1, y2) and max(y1, y2) < (h << XY_SHIFT)):
        raise ValueError("fill_ellipse: the ellipse must lie inside the "
                         "image")
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    def cdiv(a, b):                     # C integer division
        q = abs(a) // abs(b)
        return q if (a >= 0) == (b >= 0) else -q

    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _fill_convex_poly(img: np.ndarray, v: np.ndarray, color) -> None:
    """cv2's ``FillConvexPoly`` on fixed-point (shift 16) points,
    8-connected: the outline by :func:`_line2`, then two edge walkers
    from the topmost vertex filling [(xl + ½) >> 16, (xr + ½) >> 16]."""
    npts = len(v)
    h, w = img.shape[:2]
    delta = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    imin = int(np.argmin(v[:, 1]))            # the first of the topmost
    xmin, xmax = (int(v[:, 0].min()) + delta) >> XY_SHIFT, \
        (int(v[:, 0].max()) + delta) >> XY_SHIFT
    ymin, ymax = (int(v[:, 1].min()) + delta) >> XY_SHIFT, \
        (int(v[:, 1].max()) + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = (idx0 + di) % npts
                while edges > 0:
                    edges -= 1
                    ty = (int(v[idx, 1]) + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = int(v[idx0, 0]), int(v[idx, 0])
                        num, den = (xe - xs) * 2 + (ty - y), 2 * (ty - y)
                        q = abs(num) // den
                        e.update(ye=ty, dx=q if num >= 0 else -q, x=xs,
                                 idx=idx)
                        break
                    idx0 = idx
                    idx = (idx + di) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0]["x"] > edge[1]["x"] \
                else (edge[0], edge[1])
            x1 = (left["x"] + delta) >> XY_SHIFT
            x2 = (right["x"] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        for e in edge:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


def fill_ellipse(img: np.ndarray, center, axes, color: int = 255
                 ) -> np.ndarray:
    """``cv2.ellipse(img, center, axes, 0, 0, 360, color, -1)`` on a 2-D
    uint8 ``img`` (in place; returned), the ellipse inside the image."""
    axes = (abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT)
    center = (int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT)
    big = (max(axes) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if big < 3 else 30 if big < 10 else 18 if big < 15 else 5
    _fill_convex_poly(img, _ellipse_points(center, axes, delta), color)
    return img


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: [2, 3] float64, the center taken as
    float32 as cv2's ``Point2f`` takes it."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = (float(np.float32(c)) for c in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine_nearest(img: np.ndarray, m: np.ndarray, width: int,
                        height: int) -> np.ndarray:
    """``cv2.warpAffine(img, m, (width, height), flags=INTER_NEAREST)``
    with cv2's zero border: ``m`` inverted in f64 and rounded to f32,
    then each destination pixel (x, y) reads the source at
    round(fma(m0, x, m1·y + m2)), round(fma(m3, x, m4·y + m5)) in f32
    (half to even), as cv2's vectorised nearest warp computes it;
    sources outside the image read 0."""
    m = np.asarray(m, np.float64).reshape(-1).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    m = m.astype(np.float32)
    xs = np.arange(width, dtype=np.float32)[None]
    ys = np.arange(height, dtype=np.float32)[:, None]

    def coord(a, b, c):                   # fma(a, x, b·y + c) in f32
        row = b * ys + c
        return np.rint((np.float64(a) * xs + row).astype(np.float32)
                       ).astype(np.int64)

    sx, sy = coord(m[0], m[1], m[2]), coord(m[3], m[4], m[5])
    h, w = img.shape[:2]
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    out = np.zeros((height, width) + img.shape[2:], img.dtype)
    out[inside] = img[sy[inside], sx[inside]]
    return out
