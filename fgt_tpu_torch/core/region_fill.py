"""Laplacian region fill ("diffusion") of masked flow fields on the host
— counterpart of ``fgt_tpu/core/region_fill.py`` (reference
tool/utils/region_fill.py:7-126).

The Laplace equation is solved inside the hole with Dirichlet values
from the hole's 4-connected outer perimeter, by one sparse direct solve
(scipy ``spsolve``, as the JAX package does, so the datasets' diffused
flows match it); un-masked pixels are restored exactly. The perimeter is
a 3x3 cross dilation in numpy in place of ``cv2.dilate``.

The reference's ``factor != 1`` (solve on a resized grid) needs cv2's
float64 resize and raises here; only the inference CLI's
``--host_diffusion`` would reach it. The card's own diffusion is
``ops/diffusion.py``.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from scipy.sparse.linalg import spsolve


def _find_boundary(mask: np.ndarray) -> np.ndarray:
    """4-connected outside-perimeter pixels of a boolean hole mask."""
    m = mask.astype(bool)
    dilated = m.copy()
    dilated[1:] |= m[:-1]
    dilated[:-1] |= m[1:]
    dilated[:, 1:] |= m[:, :-1]
    dilated[:, :-1] |= m[:, 1:]
    return dilated & ~m


def _num_neighbors(h: int, w: int) -> np.ndarray:
    n = np.full((h, w), 4.0)
    n[0, :] = n[-1, :] = 3.0
    n[:, 0] = n[:, -1] = 3.0
    n[0, 0] = n[0, -1] = n[-1, 0] = n[-1, -1] = 2.0
    return n


def _laplace_fill(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Solve the Laplace equation on ``mask`` pixels of ``img``, in
    place."""
    h, w = img.shape
    perimeter = _find_boundary(mask)
    pvals = np.where(perimeter, img, 0.0)
    pad = np.pad(pvals, 1)
    rhs_full = pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] \
        + pad[1:-1, 2:]
    ys, xs = np.nonzero(mask)
    npix = ys.size
    if npix == 0:
        return img
    rhs = rhs_full[ys, xs]
    grid = np.full((h + 2, w + 2), -1, dtype=np.int64)
    grid[ys + 1, xs + 1] = np.arange(npix)
    rows = [np.arange(npix)]
    cols = [np.arange(npix)]
    vals = [_num_neighbors(h, w)[ys, xs]]
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        nb = grid[ys + 1 + dy, xs + 1 + dx]
        sel = nb >= 0
        rows.append(np.arange(npix)[sel])
        cols.append(nb[sel])
        vals.append(-np.ones(sel.sum()))
    a = sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(npix, npix)).tocsr()
    img[ys, xs] = spsolve(a, rhs)
    return img


def regionfill(image: np.ndarray, mask: np.ndarray, factor: float = 1.0
               ) -> np.ndarray:
    """Fill ``mask`` pixels of a single-channel ``image`` (float64 out)
    by Laplacian diffusion; un-masked pixels are the input's."""
    if factor != 1.0:
        raise NotImplementedError(
            "regionfill: factor != 1 needs cv2's float64 resize, which "
            "the port has no twin of")
    image = np.asarray(image, dtype=np.float64)
    mask = np.asarray(mask)
    if np.count_nonzero(mask) == 0:
        return image.copy()
    out = _laplace_fill(image.copy(), mask > 0)
    out[mask == 0] = image[mask == 0]
    return out


def diffuse_flow(flow: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Fill both channels of an ``[H, W, 2]`` flow, hole values zeroed
    first (reference FGT/data/train_dataset.py:101-105); float32 out."""
    mask2 = np.asarray(mask).astype(np.float64)
    if mask2.ndim == 3:
        mask2 = mask2[..., 0]
    out = np.zeros_like(flow, dtype=np.float64)
    for c in range(2):
        out[..., c] = regionfill(flow[..., c] * (1 - mask2), mask2)
    return out.astype(np.float32)
