"""Host stages s3-s5 of the plain reference, in numpy and scipy.

* s3 gradients: ``prepare_gradients`` of
  ``fgt_tpu_torch/pipeline/video_inpainting.py`` (commit ac5eac9);
* s4 flowNN: the vectorized numpy passes of the JAX package's
  ``fgt_tpu/pipeline/propagation.py`` (``_directional_pass``,
  ``_sample_chains`` and the two-candidate fusion of
  ``get_flownn_gradient``), frame-first, with cv2.remap replaced by
  ``interp`` of ``fgt_tpu_torch/pipeline/propagation.py`` (commit
  ac5eac9), which reproduces it; the port runs these steps in the
  OpenMP kernels of ``native/fgt_native.cpp`` instead;
* s5 Poisson: ``fgt_tpu_torch/pipeline/poisson.py`` (commit ac5eac9)
  with the connectivity check as the numpy fixpoint of the JAX
  package's ``fgt_tpu/pipeline/poisson.py``.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
from scipy import sparse
from scipy.sparse.linalg import splu


# ---------------- s3 ----------------

def gradient_mask(mask: np.ndarray) -> np.ndarray:
    down = np.concatenate((mask[1:, :], np.zeros((1, mask.shape[1]), bool)), 0)
    right = np.concatenate((mask[:, 1:], np.zeros((mask.shape[0], 1), bool)),
                           1)
    return np.logical_or.reduce((mask, down, right))


def prepare_gradients(video, mask, mask_dilated):
    n, h, w, _ = video.shape
    gx = np.zeros((n, h, w, 3), np.float32)
    gy = np.zeros((n, h, w, 3), np.float32)
    video = video.copy()
    for i in range(n):
        img = video[i].copy()
        img[mask[i]] = 0
        img = (img * 255).astype(np.uint8).astype(np.float32) / 255.0
        gx[i, :, :-1] = np.diff(img, axis=1)
        gy[i, :-1, :] = np.diff(img, axis=0)
        gx[i][mask_dilated[i]] = 0
        gy[i][mask_dilated[i]] = 0
        video[i] = img
    return video, gx, gy


# ---------------- s4 ----------------

def _lerp(a, b, t):
    return ((b - a).astype(np.float64) * t + a).astype(np.float32)


def interp(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear sampling of img [H, W(, C)] at float coords, zero outside
    (cv2.remap INTER_LINEAR, BORDER_CONSTANT)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    x = np.asarray(x, np.float32).reshape(-1)
    y = np.asarray(y, np.float32).reshape(-1)
    x0f, y0f = np.floor(x), np.floor(y)
    ex = (slice(None),) + (None,) * (img.ndim - 2)
    fx, fy = (x - x0f)[ex], (y - y0f)[ex]
    x0 = np.clip(x0f, -2, w).astype(np.int64)
    y0 = np.clip(y0f, -2, h).astype(np.int64)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(ok[ex], v, np.float32(0))

    top = _lerp(tap(y0, x0), tap(y0, x0 + 1), fx)
    bottom = _lerp(tap(y0 + 1, x0), tap(y0 + 1, x0 + 1), fx)
    return _lerp(top, bottom, fy)


def _cycle_uv(flow_f, flow_b):
    """Dense forward/backward cycle error components [H, W, 2]."""
    h, w = flow_f.shape[:2]
    fy, fx = np.mgrid[0:h, 0:w].astype(np.float32)
    fxx = fx + flow_b[:, :, 0]
    fyy = fy + flow_b[:, :, 1]
    u = fxx + interp(flow_f[:, :, 0], fxx, fyy).reshape(h, w) - fx
    v = fyy + interp(flow_f[:, :, 1], fxx, fyy).reshape(h, w) - fy
    return np.stack((u, v), axis=2)


def directional_pass(mask, flow_follow, flow_check, forward: bool,
                     thres: float):
    """mask [N, H, W] bool; flows [N-1, H, W, 2]. ``forward`` walks
    frames 1..N-1 along the backward flows, else N-2..0 along the
    forward ones. Returns (have, nn_x, nn_y, nn_t, cons), each [N, H, W]."""
    n, h, w = mask.shape
    have = np.zeros((n, h, w), bool)
    nn_x = np.zeros((n, h, w), np.float64)
    nn_y = np.zeros((n, h, w), np.float64)
    nn_t = np.full((n, h, w), -1, np.int64)
    cons_u = np.zeros((n, h, w), np.float64)
    cons_v = np.zeros((n, h, w), np.float64)
    for t in (range(1, n) if forward else range(n - 2, -1, -1)):
        src = t - 1 if forward else t + 1
        fi = t - 1 if forward else t
        f_follow, f_check = flow_follow[fi], flow_check[fi]
        hy, hx = np.nonzero(mask[t])
        if hy.size == 0:
            continue
        ty = hy + f_follow[hy, hx, 1]
        tx = hx + f_follow[hy, hx, 0]
        tyi = np.round(ty).astype(np.int64)
        txi = np.round(tx).astype(np.int64)
        back_u = interp(f_check[:, :, 0], tx, ty)
        back_v = interp(f_check[:, :, 1], tx, ty)
        consist = np.sqrt((ty + back_v - hy) ** 2
                          + (tx + back_u - hx) ** 2) < thres
        uv = _cycle_uv(f_check, f_follow)
        valid = (tyi >= 0) & (tyi < h - 1) & (txi >= 0) & (txi < w - 1)
        hy, hx, ty, tx = hy[valid], hx[valid], ty[valid], tx[valid]
        tyi, txi, consist = tyi[valid], txi[valid], consist[valid]
        known = ~mask[src, tyi, txi]
        sel = known & consist
        have[t, hy[sel], hx[sel]] = True
        nn_x[t, hy[sel], hx[sel]] = tx[sel]
        nn_y[t, hy[sel], hx[sel]] = ty[sel]
        nn_t[t, hy[sel], hx[sel]] = src
        cons_u[t, hy[sel], hx[sel]] = np.abs(uv[hy[sel], hx[sel], 0])
        cons_v[t, hy[sel], hx[sel]] = np.abs(uv[hy[sel], hx[sel], 1])
        # transitive chain through an already-resolved hole pixel
        sel2 = (~known) & have[src, tyi, txi] & consist
        cy = nn_y[src, tyi, txi] + (ty - tyi)
        cx = nn_x[src, tyi, txi] + (tx - txi)
        cyi = np.round(cy).astype(np.int64)
        cxi = np.round(cx).astype(np.int64)
        sel2 &= (cyi >= 0) & (cyi < h - 1) & (cxi >= 0) & (cxi < w - 1)
        sy, sx = hy[sel2], hx[sel2]
        have[t, sy, sx] = True
        nn_x[t, sy, sx] = cx[sel2]
        nn_y[t, sy, sx] = cy[sel2]
        nn_t[t, sy, sx] = nn_t[src, tyi[sel2], txi[sel2]]
        cons_u[t, sy, sx] = np.maximum(np.abs(uv[sy, sx, 0]),
                                       cons_u[src, tyi[sel2], txi[sel2]])
        cons_v[t, sy, sx] = np.maximum(np.abs(uv[sy, sx, 1]),
                                       cons_v[src, tyi[sel2], txi[sel2]])
    return have, nn_x, nn_y, nn_t, np.sqrt(cons_u ** 2 + cons_v ** 2)


def sample_chains(gradient, have, nn_x, nn_y, nn_t, forward: bool):
    """gradient [N, H, W, C]: hole pixels sampled at their chain
    endpoints, source frames in chain order (so filled values feed
    later frames)."""
    out = gradient.copy()
    n = gradient.shape[0]
    for s in (range(n) if forward else range(n - 1, -1, -1)):
        ts, ys, xs = np.nonzero(have & (nn_t == s))
        if ts.size:
            out[ts, ys, xs] = interp(out[s], nn_x[ts, ys, xs],
                                     nn_y[ts, ys, xs])
    return out


def flownn(gx, gy, mask, flow_f, flow_b, thres=5.0, alpha=0.1):
    """s4 on [N, H, W, 3] gradients: returns (gx, gy, mask_tofill)."""
    bn = directional_pass(mask, flow_b, flow_f, True, thres)
    fn = directional_pass(mask, flow_f, flow_b, False, thres)
    both = np.concatenate([gx, gy], axis=3)
    s_bn = sample_chains(both, *bn[:4], True)
    s_fn = sample_chains(both, *fn[:4], False)
    ts, ys, xs = np.nonzero(mask)
    have = np.stack([bn[0][ts, ys, xs], fn[0][ts, ys, xs]], -1)
    cons = np.stack([bn[4][ts, ys, xs], fn[4][ts, ys, xs]], -1)
    wts = np.exp(-cons / alpha) * have
    wsum = wts.sum(-1, keepdims=True)
    fallback = have / np.maximum(have.sum(-1, keepdims=True), 1)
    wts = np.where(wsum > 0, wts / np.maximum(wsum, 1e-30), fallback)
    any_nn = have.any(-1)
    fused = (s_bn[ts, ys, xs] * wts[:, :1] + s_fn[ts, ys, xs] * wts[:, 1:])
    gx, gy = gx.copy(), gy.copy()
    c = gx.shape[3]
    gx[ts, ys, xs] = np.where(any_nn[:, None], fused[:, :c], gx[ts, ys, xs])
    gy[ts, ys, xs] = np.where(any_nn[:, None], fused[:, c:], gy[ts, ys, xs])
    tofill = np.zeros(mask.shape, bool)
    tofill[ts, ys, xs] = ~any_nn
    return gx, gy, tofill


# ---------------- s5 ----------------

def unfilled_mask(hole: np.ndarray, gm: np.ndarray) -> np.ndarray:
    """Hole pixels not reached from known pixels through gradient-valid
    paths (both raster sweeps, iterated to their fixpoint)."""
    tl = hole.copy()
    while True:
        up_ok = np.zeros_like(tl)
        up_ok[1:, :] = (~tl[:-1, :]) & (~gm[:-1, :])
        left_ok = np.zeros_like(tl)
        left_ok[:, 1:] = (~tl[:, :-1]) & (~gm[:, :-1])
        new = tl & ~(up_ok | left_ok)
        if np.array_equal(new, tl):
            break
        tl = new
    br = hole.copy()
    while True:
        down_ok = np.zeros_like(br)
        down_ok[:-1, :] = ~br[1:, :]
        right_ok = np.zeros_like(br)
        right_ok[:, :-1] = ~br[:, 1:]
        new = br & ~((down_ok | right_ok) & (~gm))
        if np.array_equal(new, br):
            break
        br = new
    return tl & br


def poisson_blend(img, grad_x, grad_y, hole_mask, gradient_mask_):
    """One frame: least squares for the hole pixels against the
    propagated gradients (4 neighbours; known neighbours as Dirichlet
    values). Returns (blended [H, W, 3] f64, unfilled [H, W] bool)."""
    H, W, C = img.shape
    hole, gm = hole_mask.astype(bool), gradient_mask_.astype(bool)
    if not hole.any():
        return img.astype(np.float64), np.zeros((H, W), bool)
    gx = np.zeros((H, W, C), np.float64)
    gy = np.zeros((H, W, C), np.float64)
    gx[:, :grad_x.shape[1]] = grad_x
    gy[:grad_y.shape[0], :] = grad_y
    py, px = np.nonzero(hole)
    npix = py.size
    col_of = np.full((H, W), -1, np.int64)
    col_of[py, px] = np.arange(npix)
    srcs = (lambda y, x: -gx[y, x], lambda y, x: -gy[y, x],
            lambda y, x: gx[y, x - 1], lambda y, x: gy[y - 1, x])
    dirs = ((0, 1, 0, lambda y, x: ~gm[y, x]),
            (1, 0, 1, lambda y, x: ~gm[y, x]),
            (0, -1, 2, lambda y, x: ~gm[y, x - 1]),
            (-1, 0, 3, lambda y, x: ~gm[y - 1, x]))
    rows, cols, vals, rhs = [], [], [], []
    eq = 0
    for dy, dx, gsrc, gok in dirs:
        qy, qx = py + dy, px + dx
        valid = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
        vy, vx, qy, qx = py[valid], px[valid], qy[valid], qx[valid]
        havegrad = gok(vy, vx)
        q_known = ~hole[qy, qx]
        selb = havegrad & q_known
        n = int(selb.sum())
        rows.append(np.arange(eq, eq + n))
        cols.append(col_of[vy[selb], vx[selb]])
        vals.append(np.ones(n))
        rhs.append(srcs[gsrc](vy[selb], vx[selb]) + img[qy[selb], qx[selb]])
        eq += n
        seli = havegrad & ~q_known
        n = int(seli.sum())
        rows += [np.arange(eq, eq + n)] * 2
        cols += [col_of[vy[seli], vx[seli]], col_of[qy[seli], qx[seli]]]
        vals += [np.ones(n), -np.ones(n)]
        rhs.append(srcs[gsrc](vy[seli], vx[seli]))
        eq += n
    a = sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                  np.concatenate(cols))),
                          shape=(eq, npix))
    lu = splu((a.T @ a + 1e-8 * sparse.eye(npix)).tocsc())
    recon = lu.solve(a.T @ np.concatenate(rhs, axis=0))
    out = img.astype(np.float64).copy()
    out[py, px] = recon
    return out, unfilled_mask(hole, gm)


def frame_holes(masks: np.ndarray, dilates: int) -> np.ndarray:
    """[N, H, W] bool: each frame's hole (nonzero) dilated ``dilates``
    times."""
    holes = np.asarray(masks) > 0
    if dilates <= 0:
        return holes
    return np.stack([scipy.ndimage.binary_dilation(m, iterations=dilates)
                     for m in holes])


def propagate(frames255, masks, flow_f, flow_b, thres=5.0, alpha=0.1):
    """s3-s5 of object removal. frames255 [N, H, W, 3] in [0, 255];
    masks [N, H, W] (nonzero = hole, as s3-s5 take it, dilated where the
    run dilates it); completed flows [N-1, H, W, 2]. Returns (Poisson
    frames [N, H, W, 3] in [0, 1], pixels left for FGT [N, H, W] bool)."""
    video = np.asarray(frames255, np.float32) / 255.0
    mask = np.asarray(masks) > 0
    mask_dilated = np.stack([gradient_mask(m) for m in mask])
    video, gx, gy = prepare_gradients(video, mask, mask_dilated)
    gx, gy, tofill = flownn(gx, gy, mask, flow_f, flow_b, thres, alpha)
    tofill = np.stack([scipy.ndimage.binary_fill_holes(m) for m in tofill])
    n, h, w = mask.shape
    mask_cur = mask.copy()
    blends = []
    for i in range(n):
        if mask_cur[i].any():
            blend, unfilled = poisson_blend(video[i], gx[i][:, :w - 1],
                                            gy[i][:h - 1], mask_cur[i],
                                            tofill[i])
            blends.append(np.clip(blend, 0, 1.0))
            mask_cur[i] = unfilled
        else:
            blends.append(video[i])
    return np.stack(blends), mask_cur
