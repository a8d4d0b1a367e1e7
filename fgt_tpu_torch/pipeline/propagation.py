"""Flow-guided gradient propagation (flowNN), stage s4 — the port's own
copy of the frame-first native path of ``fgt_tpu/pipeline/propagation.py``
(``get_flownn_gradient_frames``; reference tool/get_flowNN_gradient.py).

1. Two chaining passes (forward along backward flows, backward along
   forward flows) find, for every hole pixel, a chain endpoint in a frame
   where the pixel is known, gated by forward/backward cycle consistency.
2. Gradients are sampled at the chain endpoints, in chain order, so
   transitively filled values feed later frames.
3. The two candidates are fused with weights exp(-consistency/alpha);
   pixels with no candidate come back as the still-unfilled mask.

All three steps run in the OpenMP kernels of ``native/fgt_native.cpp``.

``--Nonlocal`` runs :func:`get_flownn_gradient`, the reference-layout
entry point (``[H, W, ..., N]`` arrays): the same two chaining passes and
samplings, then per frame the fusion adds three candidates sampled from
the key frames ``[0, N//2, N-1]`` through precomputed RAFT flows, each
gated by its own cycle consistency (:func:`_nonlocal_frame`). Its
bilinear sampling, :func:`interp`, reproduces ``cv2.remap``
(``INTER_LINEAR``, zero border) bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fgt_tpu_torch import native
from fgt_tpu_torch.pipeline.image_io import lerp_f32


@dataclasses.dataclass
class PropagationConfig:
    consistency_thres: float = 5.0
    alpha: float = 0.1


def get_flownn_gradient_frames(cfg: PropagationConfig,
                               gradient_x: np.ndarray,
                               gradient_y: np.ndarray, mask: np.ndarray,
                               video_flow_f: np.ndarray,
                               video_flow_b: np.ndarray):
    """gradient_x/y: [N, H, W, C]; mask: [N, H, W] bool; video_flow_f/b:
    [N-1, H, W, 2]. CONSUMES contiguous f32 gradients (filled in place).

    Returns (gradient_x, gradient_y, mask_tofill), frame-first."""
    mask_n = np.ascontiguousarray(mask, np.uint8)
    vf = np.ascontiguousarray(video_flow_f, np.float32)
    vb = np.ascontiguousarray(video_flow_b, np.float32)
    bn_pass = native.flownn_pass(mask_n, vb, vf, True, cfg.consistency_thres)
    fn_pass = native.flownn_pass(mask_n, vf, vb, False, cfg.consistency_thres)

    gx = np.ascontiguousarray(gradient_x, np.float32)
    gy = np.ascontiguousarray(gradient_y, np.float32)
    # one chain walk per direction over its own evolving copy (gx|gy
    # stacked on channels), sampled in place
    s_bn = np.concatenate([gx, gy], axis=3)
    s_fn = np.concatenate([gx, gy], axis=3)
    native.flownn_sample(s_bn, *bn_pass[:4], True)
    native.flownn_sample(s_fn, *fn_pass[:4], False)
    tofill = native.flownn_fuse(gx, gy, s_bn, s_fn, bn_pass, fn_pass, mask_n,
                                cfg.alpha)
    return gx, gy, tofill.view(bool)


def interp(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Bilinear sampling of ``img`` [H, W(, C)] at float coords, zero
    outside: cv2.remap ``INTER_LINEAR`` / ``BORDER_CONSTANT`` with its
    arithmetic, :func:`lerp_f32` along x, then along y. Returns [n(, C)]."""
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

    top = lerp_f32(tap(y0, x0), tap(y0, x0 + 1), fx)
    bottom = lerp_f32(tap(y0 + 1, x0), tap(y0 + 1, x0 + 1), fx)
    return lerp_f32(top, bottom, fy)


def consist_check(flow_f: np.ndarray, flow_b: np.ndarray):
    """Dense forward/backward cycle error (reference
    common_utils.py:234-256). Returns (|err| [H, W], (u, v) [H, W, 2])."""
    h, w = flow_f.shape[:2]
    fy, fx = np.mgrid[0:h, 0:w].astype(np.float32)
    fxx = fx + flow_b[:, :, 0]
    fyy = fy + flow_b[:, :, 1]
    u = fxx + interp(flow_f[:, :, 0], fxx, fyy).reshape(h, w) - fx
    v = fyy + interp(flow_f[:, :, 1], fxx, fyy).reshape(h, w) - fy
    err = np.sqrt(u ** 2 + v ** 2)
    return err, np.stack((u, v), axis=2)


def key_frames(n: int) -> tuple:
    """The --Nonlocal key source frames."""
    return 0, n // 2, n - 1


def _nonlocal_frame(t, mask, nl_flow_f, nl_flow_b, gradient_x, gradient_y,
                    cfg):
    """Non-local key-frame candidates for frame ``t`` (reference
    common_utils.py:332-417), sampled from the EVOLVING gradient arrays.

    nl_flow_f/b: [H, W, 2, 3, N], flow from t to key k / key k to t.
    Returns (have [H, W, 3] bool, cons [H, W, 3], gx_k, gy_k [H, W, C, 3])."""
    h, w, n = mask.shape
    hy, hx = np.nonzero(mask[:, :, t])
    have = np.zeros((h, w, 3), bool)
    cons = np.zeros((h, w, 3), np.float64)
    c = gradient_x.shape[2]
    gx_k = np.zeros((h, w, c, 3), gradient_x.dtype)
    gy_k = np.zeros((h, w, c, 3), gradient_y.dtype)
    for k, key in enumerate(key_frames(n)):
        ff = nl_flow_f[:, :, :, k, t]
        fb = nl_flow_b[:, :, :, k, t]
        cons[:, :, k], _ = consist_check(fb, ff)
        gx_k[:, :, :, k] = gradient_x[:, :, :, t]
        gy_k[:, :, :, k] = gradient_y[:, :, :, t]
        if hy.size == 0:
            continue
        tx = hx + ff[hy, hx, 0]
        ty = hy + ff[hy, hx, 1]
        bu = interp(fb[:, :, 0], tx, ty)
        bv = interp(fb[:, :, 1], tx, ty)
        diff = np.sqrt((ty + bv - hy) ** 2 + (tx + bu - hx) ** 2)
        tyi = np.round(ty).astype(np.int64)
        txi = np.round(tx).astype(np.int64)
        valid = (tyi >= 0) & (tyi < h - 1) & (txi >= 0) & (txi < w - 1)
        sel = valid & (diff < cfg.consistency_thres)
        sel[sel] &= mask[tyi[sel], txi[sel], key] == 0
        if not sel.any():
            continue
        sy, sx = hy[sel], hx[sel]
        have[sy, sx, k] = True
        gx_k[sy, sx, :, k] = interp(gradient_x[:, :, :, key], tx[sel], ty[sel])
        gy_k[sy, sx, :, k] = interp(gradient_y[:, :, :, key], tx[sel], ty[sel])
    return have, cons, gx_k, gy_k


def _chain_pass(mask, follow, check, forward, cfg, grads):
    """One native chaining pass plus its endpoint sampling of ``grads``
    ([N, H, W, 2C]), in the reference layout: (have, sampled [H, W, 2C, N],
    cons [H, W, N])."""
    have, nn_x, nn_y, nn_t, cons_u, cons_v = native.flownn_pass(
        mask, follow, check, forward, cfg.consistency_thres)
    sampled = grads.copy()
    native.flownn_sample(sampled, have, nn_x, nn_y, nn_t, forward)
    return (have.transpose(1, 2, 0).astype(bool),
            sampled.transpose(1, 2, 3, 0),
            np.sqrt(cons_u * cons_u + cons_v * cons_v).transpose(1, 2, 0))


def get_flownn_gradient(cfg: PropagationConfig, gradient_x: np.ndarray,
                        gradient_y: np.ndarray, mask: np.ndarray,
                        video_flow_f: np.ndarray, video_flow_b: np.ndarray,
                        nonlocal_flow_f: np.ndarray,
                        nonlocal_flow_b: np.ndarray):
    """flowNN with the --Nonlocal key-frame candidates, in the reference
    layout: gradient_x/y [H, W, C, N]; mask [H, W, N] bool; video_flow_f/b
    [H, W, 2, N-1]; nonlocal_flow_f/b [H, W, 2, 3, N]. Frames are fused in
    order, each reading the gradients fused before it.

    Returns (gradient_x, gradient_y, mask_tofill), reference layout."""
    h, w, n = mask.shape
    c = gradient_x.shape[2]
    mask_n = np.ascontiguousarray(mask.transpose(2, 0, 1), np.uint8)
    vf = np.ascontiguousarray(video_flow_f.transpose(3, 0, 1, 2), np.float32)
    vb = np.ascontiguousarray(video_flow_b.transpose(3, 0, 1, 2), np.float32)
    grads = np.ascontiguousarray(np.concatenate(
        [gradient_x, gradient_y], axis=2).transpose(3, 0, 1, 2), np.float32)
    have_bn, s_bn, cons_bn = _chain_pass(mask_n, vb, vf, True, cfg, grads)
    have_fn, s_fn, cons_fn = _chain_pass(mask_n, vf, vb, False, cfg, grads)

    gradient_x = gradient_x.copy()
    gradient_y = gradient_y.copy()
    mask_tofill = np.zeros((h, w, n), dtype=bool)
    for t in range(n):
        have_k, cons_k, gx_k, gy_k = _nonlocal_frame(
            t, mask, nonlocal_flow_f, nonlocal_flow_b, gradient_x,
            gradient_y, cfg)
        have = np.stack([have_bn[:, :, t], have_fn[:, :, t]]
                        + [have_k[:, :, k] for k in range(3)], axis=2)
        cons = np.stack([cons_bn[:, :, t], cons_fn[:, :, t]]
                        + [cons_k[:, :, k] for k in range(3)], axis=2)
        any_nn = have.any(axis=2)
        wts = np.exp(-cons / cfg.alpha) * have
        wsum = wts.sum(axis=2, keepdims=True)
        # numerical fallback: uniform over the available candidates
        fallback = have / np.maximum(have.sum(axis=2, keepdims=True), 1)
        weights = np.where(wsum > 0, wts / np.maximum(wsum, 1e-30), fallback)
        for grad, lo, keyed in ((gradient_x, 0, gx_k), (gradient_y, c, gy_k)):
            cands = ([s_bn[:, :, lo:lo + c, t], s_fn[:, :, lo:lo + c, t]]
                     + [keyed[:, :, :, k] for k in range(3)])
            fused = sum(cand * weights[:, :, i:i + 1]
                        for i, cand in enumerate(cands))
            grad[:, :, :, t] = np.where(any_nn[:, :, None], fused,
                                        grad[:, :, :, t])
        mask_tofill[:, :, t] = (~any_nn) & mask[:, :, t]
    return gradient_x, gradient_y, mask_tofill
