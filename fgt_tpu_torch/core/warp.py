"""Backward and forward warping, NHWC — counterpart of
``fgt_tpu/core/warp.py``.

* :func:`image_warp` — bilinear backward warp with zero padding, the
  reference's ``grid_sample`` warp (LAFC/models/utils/fbConsistencyCheck.py:
  8-26, align_corners=True) written as the JAX package writes it: a
  gather at pixel coordinates, each of the four taps zeroed out of
  bounds. Not ``F.grid_sample``: its normalise/unnormalise round trip
  moves integer coordinates by an ulp, so ``floor`` flips there and the
  gradient with respect to the flow changes (the values do not:
  bilinear interpolation is continuous).
* :func:`bilinear_sampler` — the same sampling at given pixel
  coordinates (reference RAFT/utils/utils.py:57-72).
* :func:`forward_warp_splat` / :func:`reverse_flow` — gaussian-splat
  forward warping and flow reversal (reference
  FGT/data/util/flow_utils/flow_reversal.py:4-100). The splat sums with
  ``index_add_``, which on the card runs on atomics, so its order of
  summation is free there.
"""

from __future__ import annotations

import torch


def _gather_bilinear(img: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Sample ``img [B, H, W, C]`` at pixel coords ``x, y [B, N]`` ->
    [B, N, C]; out-of-bounds taps contribute zero."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1

    def tap(xi, yi, wt):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        wt = wt * valid.to(img.dtype)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * wt[..., None]

    return (tap(x0, y0, wx0 * wy0) + tap(x1, y0, wx1 * wy0)
            + tap(x0, y1, wx0 * wy1) + tap(x1, y1, wx1 * wy1))


def _pixel_grid(h: int, w: int, like: torch.Tensor):
    ys = torch.arange(h, dtype=like.dtype, device=like.device)
    xs = torch.arange(w, dtype=like.dtype, device=like.device)
    return torch.meshgrid(ys, xs, indexing="ij")


def image_warp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp ``image [B, H, W, C]`` by ``flow [B, H, W, 2]``
    (u, v): ``out[b, y, x] = image[b, y + v, x + u]``, bilinear, zero
    padding."""
    b, h, w, c = image.shape
    ys, xs = _pixel_grid(h, w, image)
    x = (xs + flow[..., 0]).reshape(b, -1)
    y = (ys + flow[..., 1]).reshape(b, -1)
    return _gather_bilinear(image, x, y).reshape(b, h, w, c)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img [B, H, W, C]`` at pixel ``coords [B, N, 2]`` (x, y)
    -> [B, N, C]; out-of-bounds taps contribute zero."""
    return _gather_bilinear(img, coords[..., 0], coords[..., 1])


def forward_warp_splat(flow: torch.Tensor, data: torch.Tensor,
                       sigma: float = 0.5):
    """Forward-warp ``data [B, H, W, C]`` along ``flow [B, H, W, 2]``,
    each pixel splatted onto the 4 integer pixels around its target with
    weight exp(-d² / sigma²). Returns ``(accumulated [B, H, W, C],
    weight_sum [B, H, W, 1])``."""
    b, h, w, c = data.shape
    ys, xs = _pixel_grid(h, w, flow)
    tx = (xs + flow[..., 0]).reshape(b, -1)
    ty = (ys + flow[..., 1]).reshape(b, -1)
    vals = data.reshape(b, -1, c)
    base = (torch.arange(b, device=data.device) * (h * w))[:, None]
    acc = data.new_zeros(b * h * w, c)
    wacc = data.new_zeros(b * h * w, 1)
    x0, y0 = torch.floor(tx), torch.floor(ty)
    for dx in (0.0, 1.0):
        for dy in (0.0, 1.0):
            xi, yi = x0 + dx, y0 + dy
            d2 = (tx - xi) ** 2 + (ty - yi) ** 2
            wt = torch.exp(-d2 / (sigma ** 2))
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            wt = wt * valid.to(data.dtype)
            idx = (base + yi.clamp(0, h - 1).long() * w
                   + xi.clamp(0, w - 1).long()).reshape(-1)
            acc = acc.index_add(0, idx, (vals * wt[..., None]).reshape(-1, c))
            wacc = wacc.index_add(0, idx, wt.reshape(-1, 1))
    return acc.reshape(b, h, w, c), wacc.reshape(b, h, w, 1)


def reverse_flow(flow: torch.Tensor, sigma: float = 0.5) -> torch.Tensor:
    """Invert a flow field by forward-splatting its negation."""
    acc, wt = forward_warp_splat(flow, -flow, sigma=sigma)
    return torch.where(wt > 1e-6, acc / wt.clamp(min=1e-6),
                       torch.zeros_like(acc))
