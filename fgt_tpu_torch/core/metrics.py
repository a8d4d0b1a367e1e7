"""Image / flow quality metrics: PSNR, SSIM, L1, L2 — the port's own copy
of ``fgt_tpu/core/metrics.py``.

Pure numpy implementations matching the semantics the reference gets from
skimage (reference FGT/metrics/__init__.py:9-31) plus the MATLAB-style
gaussian-window SSIM it also ships (FGT/metrics/ssim.py:5-58) and the
flow-domain variants that first map flow to RGB via the color wheel
(LAFC/metrics/__init__.py:10-26).

The JAX package's ``ssim_matlab`` filters with ``cv2.filter2D``; the GPU
machine has no cv2, so here the same 11x11 gaussian window is applied by
``scipy.ndimage.correlate`` in float64. The ``[5:-5, 5:-5]`` crop keeps
only pixels whose window lies inside the image, so the border mode does
not matter; the two filters differ by float64 summation order only.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage

from fgt_tpu_torch.core.flow_viz import flow_to_rgb


def _data_range(img: np.ndarray) -> float:
    return 255.0 if img.dtype == np.uint8 else 1.0


def psnr(result: np.ndarray, gt: np.ndarray, data_range: float | None = None) -> float:
    """Peak signal-to-noise ratio (skimage.peak_signal_noise_ratio contract)."""
    if data_range is None:
        data_range = _data_range(gt)
    a = result.astype(np.float64)
    b = gt.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / mse))


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with reflect padding via separable cumulative sums."""
    pad = size // 2
    out = img.astype(np.float64)
    for axis in (0, 1):
        padded = np.pad(out, [(pad, pad) if ax == axis else (0, 0)
                              for ax in range(out.ndim)], mode="reflect")
        c = np.cumsum(padded, axis=axis)
        zero = np.zeros_like(np.take(c, [0], axis=axis))
        c = np.concatenate([zero, c], axis=axis)
        hi = [slice(None)] * out.ndim
        lo = [slice(None)] * out.ndim
        hi[axis] = slice(size, size + img.shape[axis])
        lo[axis] = slice(0, img.shape[axis])
        out = (c[tuple(hi)] - c[tuple(lo)]) / size
    return out


def ssim_single(result: np.ndarray, gt: np.ndarray,
                data_range: float | None = None, win_size: int = 7,
                K1: float = 0.01, K2: float = 0.03) -> float:
    """Single-channel SSIM, skimage default semantics (uniform 7x7 window,
    sample covariance normalization, mean over the crop-valid region).

    skimage computes filters over the full (reflect-padded) image and then
    crops ``win_size // 2`` from each border before averaging; we do the same.
    """
    if data_range is None:
        data_range = _data_range(gt)
    x = result.astype(np.float64)
    y = gt.astype(np.float64)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)  # sample covariance

    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    num = (2 * ux * uy + C1) * (2 * vxy + C2)
    den = (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2)
    s = num / den
    pad = (win_size - 1) // 2
    return float(s[pad:-pad or None, pad:-pad or None].mean())


def ssim(result: np.ndarray, gt: np.ndarray, data_range: float | None = None,
         multichannel: bool = True, win_size: int = 7) -> float:
    """SSIM; channels averaged independently when multichannel."""
    if result.ndim == 3 and multichannel:
        vals = [ssim_single(result[..., c], gt[..., c], data_range, win_size)
                for c in range(result.shape[-1])]
        return float(np.mean(vals))
    return ssim_single(result, gt, data_range, win_size)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """'valid' correlation with ``k``: the filtered image without the
    border whose window leaves the image."""
    p = k.shape[0] // 2
    return scipy.ndimage.correlate(img, k, mode="mirror")[p:-p, p:-p]


def ssim_matlab(result: np.ndarray, gt: np.ndarray) -> float:
    """MATLAB-style gaussian-window SSIM on uint8 single-channel images
    (reference FGT/metrics/ssim.py:13-41, 'valid' convolution)."""
    x = result.astype(np.float64)
    y = gt.astype(np.float64)
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    k = _gaussian_kernel(11, 1.5)
    mu1 = _filter_valid(x, k)
    mu2 = _filter_valid(y, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _filter_valid(x * x, k) - mu1_sq
    s2 = _filter_valid(y * y, k) - mu2_sq
    s12 = _filter_valid(x * y, k) - mu1_mu2
    m = ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return float(m.mean())


def calculate_metrics(results: np.ndarray, gts: np.ndarray) -> dict:
    """Batch frame metrics (uint8 ``[B, H, W, C]``); contract of reference
    FGT/metrics/__init__.py:9-31."""
    B, H, W, C = results.shape
    psnrs, ssims, l1s, l2s = [], [], [], []
    for i in range(B):
        r, g = results[i], gts[i]
        residual = r.astype(np.float64) - g.astype(np.float64)
        l1s.append(np.mean(np.abs(residual)))
        l2s.append(np.sum(residual ** 2) ** 0.5 / (H * W * C))
        psnrs.append(psnr(r, g))
        ssims.append(ssim(r, g, multichannel=True))
    return {"l1": float(np.mean(l1s)), "l2": float(np.mean(l2s)),
            "psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}


def calculate_flow_metrics(results_flow: np.ndarray, gts_flow: np.ndarray) -> dict:
    """Batch flow metrics: PSNR/SSIM on the flow->RGB rendering, L1/L2 on raw
    flow values (reference LAFC/metrics/__init__.py:10-26)."""
    B, H, W, C = results_flow.shape
    psnrs, ssims, l1s, l2s = [], [], [], []
    for i in range(B):
        r, g = results_flow[i], gts_flow[i]
        r_rgb = flow_to_rgb(r)
        g_rgb = flow_to_rgb(g)
        residual = r - g
        l1s.append(np.mean(np.abs(residual)))
        l2s.append(np.sum(residual ** 2) ** 0.5 / (H * W * C))
        psnrs.append(psnr(r_rgb, g_rgb, data_range=1.0))
        ssims.append(ssim(r_rgb, g_rgb, data_range=1.0, multichannel=True))
    return {"l1": float(np.mean(l1s)), "l2": float(np.mean(l2s)),
            "psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
