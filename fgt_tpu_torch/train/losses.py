"""Training losses, NHWC — counterpart of ``fgt_tpu/train/losses.py``:

* masked/valid mean-normalized L1      (FGT/networks/network.py:146-151)
* adversarial hinge / nsgan / lsgan    (LAFC/models/utils/flow_losses.py:88-125)
* generalized charbonnier              (flow_losses.py:418-434)
* 1st / 2nd order flow smoothness      (flow_losses.py:383-415, 437-464)
* ternary (census) loss + occlusion    (fbConsistencyCheck.py:56-108,
                                        LAFC/networks/network.py:164-172)
* pos/neg-weighted edge BCE + EdgeAcc  (bce_edge_loss.py:6-59)
* forward-backward consistency         (flow_losses.py:315-376, 489-517)

Reference quirks kept, as the JAX package keeps them:

* the edge loss applies BCE-with-logits to predictions that already
  passed a sigmoid;
* smoothness takes the hole mask, not the boundary mask its helper
  computes;
* the census gray's blue weight is 0.110, not 0.114;
* the census patches are zero-padded, so a tap past the border reads
  ``-I``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fgt_tpu_torch.core.warp import image_warp


def l1_normalized(pred: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """``L1(pred*m, target*m) / mean(m)``."""
    return torch.mean(torch.abs(pred * mask - target * mask)) / torch.clamp(
        torch.mean(mask), min=1e-8)


def adversarial_loss(outputs: torch.Tensor, is_real: bool, is_disc: bool,
                     kind: str = "hinge") -> torch.Tensor:
    if kind == "hinge":
        if is_disc:
            sign = -1.0 if is_real else 1.0
            return torch.mean(torch.relu(1.0 + sign * outputs))
        return torch.mean(-outputs)
    target = torch.ones_like(outputs) if is_real else torch.zeros_like(outputs)
    if kind == "nsgan":
        p = torch.clamp(outputs, 1e-7, 1 - 1e-7)
        return torch.mean(-(target * torch.log(p)
                            + (1 - target) * torch.log(1 - p)))
    if kind == "lsgan":
        return torch.mean((outputs - target) ** 2)
    raise ValueError(kind)


# ---------------- charbonnier / smoothness ----------------

def charbonnier(x: torch.Tensor, mask: torch.Tensor | None = None,
                alpha: float = 0.45, beta: float = 1.0,
                epsilon: float = 0.001) -> torch.Tensor:
    error = torch.pow((x * beta) ** 2 + epsilon ** 2, alpha)
    if mask is not None:
        error = error * mask
    return torch.sum(error) / x.numel()


_FILTER_X = ((0, 0, 0.), (0, 1, -1), (0, 0, 0))
_FILTER_Y = ((0, 0, 0.), (0, 1, 0), (0, -1, 0))
_FILTER_X2 = ((0, 0, 0.), (1, -2, 1), (0, 0, 0))
_FILTER_Y2 = ((0, 1, 0.), (0, -2, 0), (0, 1, 0))
_FILTER_D1 = ((1, 0, 0.), (0, -2, 0), (0, 0, 1))
_FILTER_D2 = ((0, 0, 1.), (0, -2, 0), (1, 0, 0))


def _flow_deltas(flow: torch.Tensor, filters):
    """A bank of 3x3 difference filters (cross-correlation, zero
    padding) per flow channel: flow [B, H, W, 2] -> (delta_u, delta_v),
    each [B, H, W, n_filters]."""
    k = torch.tensor(filters, dtype=flow.dtype, device=flow.device)[:, None]
    planes = flow.permute(0, 3, 1, 2)
    out = [F.conv2d(planes[:, i:i + 1], k, padding=1).permute(0, 2, 3, 1)
           for i in range(2)]
    return out[0], out[1]


def smoothness_loss(flow: torch.Tensor, cmask: torch.Tensor) -> torch.Tensor:
    """First-order charbonnier smoothness; ``cmask`` is the hole mask
    [B, H, W, 1] (the reference passes target_mask here)."""
    du, dv = _flow_deltas(flow, (_FILTER_X, _FILTER_Y))
    return charbonnier(du, cmask) + charbonnier(dv, cmask)


def second_order_loss(flow: torch.Tensor, cmask: torch.Tensor) -> torch.Tensor:
    du, dv = _flow_deltas(flow, (_FILTER_X2, _FILTER_Y2, _FILTER_D1,
                                 _FILTER_D2))
    return charbonnier(du, cmask) + charbonnier(dv, cmask)


# ---------------- ternary (census) ----------------

def _rgb2gray(img: torch.Tensor) -> torch.Tensor:
    return (img[..., 0] * 0.299 + img[..., 1] * 0.587
            + img[..., 2] * 0.110)[..., None]


def ternary_transform(image: torch.Tensor,
                      max_distance: int = 1) -> torch.Tensor:
    """Census transform: image [B, H, W, 3] in [0, 1] -> [B, H, W,
    patch²], each tap's difference to the centre, soft-normalized."""
    patch = 2 * max_distance + 1
    intensities = _rgb2gray(image) * 255.0
    b, h, w, _ = intensities.shape
    patches = F.unfold(intensities.permute(0, 3, 1, 2), patch,
                       padding=max_distance)
    patches = patches.transpose(1, 2).reshape(b, h, w, patch * patch)
    transf = patches - intensities
    return transf / torch.sqrt(0.81 + transf ** 2)


def hamming_distance(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    dist = (t1 - t2) ** 2
    return torch.sum(dist / (0.1 + dist), dim=-1, keepdim=True)


def ternary_loss(comp_flow: torch.Tensor, gt_flow: torch.Tensor,
                 mask: torch.Tensor, current_frame: torch.Tensor,
                 shift_frame: torch.Tensor) -> torch.Tensor:
    """Census loss between the current frame and the shift frame warped
    by the completed flow, gated by a soft non-occlusion mask from the
    GT flow (reference LAFC/networks/network.py:164-172). Flows
    [B, H, W, 2], frames [B, H, W, 3], mask [B, H, W, 1]."""
    warped_gt = image_warp(shift_frame, gt_flow)
    diff = torch.sum(torch.abs(current_frame - warped_gt), dim=-1,
                     keepdim=True)
    noc_mask = torch.exp(-50.0 * diff ** 2)
    warped_comp = image_warp(shift_frame, comp_flow)
    t1 = ternary_transform(current_frame)
    t21 = ternary_transform(warped_comp)
    dist = hamming_distance(t1, t21)
    return torch.mean(dist * noc_mask * mask) / torch.clamp(
        torch.mean(mask), min=1e-8)


# ---------------- edge ----------------

def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def edge_loss(pred_edges: torch.Tensor, gt_edges: torch.Tensor) -> torch.Tensor:
    """Pos/neg-frequency-weighted BCE (reference bce_edge_loss.py:6-25),
    the with-logits form applied to sigmoided predictions (quirk kept)."""
    x = _at_least_f32(pred_edges)
    z = _at_least_f32(gt_edges)
    mask = (gt_edges > 0.5).to(x.dtype)
    b = mask.shape[0]
    num_pos = torch.sum(mask.reshape(b, -1), dim=1)
    total = mask[0].numel()
    num_neg = total - num_pos
    neg_w = (num_neg / total).reshape(b, 1, 1, 1)
    pos_w = (num_pos / total).reshape(b, 1, 1, 1)
    weight = neg_w * mask + pos_w * (1 - mask)
    # bce_with_logits: max(x, 0) - x z + log(1 + exp(-|x|))
    bce = torch.clamp(x, min=0) - x * z + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.mean(weight * bce)


def edge_accuracy(pred_edge: torch.Tensor, gt_edge: torch.Tensor,
                  threshold: float = 0.5):
    """(precision, recall) at a threshold (reference
    bce_edge_loss.py:28-59); 1 where there is nothing to count."""
    labels = gt_edge > threshold
    preds = pred_edge > threshold
    relevant = torch.sum(labels.float())
    selected = torch.sum(preds.float())
    tp = torch.sum(((preds == labels) & labels).float())
    one = torch.ones_like(tp)
    precision = torch.where(selected > 0, tp / (selected + 1e-8), one)
    recall = torch.where(relevant > 0, tp / (relevant + 1e-8), one)
    return precision, recall


# ---------------- forward-backward consistency ----------------

def create_outgoing_mask(flow: torch.Tensor) -> torch.Tensor:
    """1 where the flow stays in bounds: [B, H, W, 2] -> [B, H, W, 1]."""
    _, h, w, _ = flow.shape
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    px = xs + flow[..., 0]
    py = ys + flow[..., 1]
    inside = (px <= w - 1) & (px >= 0) & (py <= h - 1) & (py >= 0)
    return inside[..., None].to(flow.dtype)


def fb_consistency_loss(forward_flow: torch.Tensor,
                        backward_flow: torch.Tensor,
                        forward_gt: torch.Tensor, backward_gt: torch.Tensor,
                        fb_weight: float = 1.0) -> torch.Tensor:
    """UnFlow-style cycle consistency with GT-flow occlusion masking
    (reference flow_losses.py:315-376, without the image-warp term, as
    the reference's default loss mix)."""
    mask_fw = create_outgoing_mask(forward_flow)
    mask_bw = create_outgoing_mask(backward_flow)

    fw_warped = image_warp(forward_flow, backward_gt)
    fw_warped_gt = image_warp(forward_gt, backward_gt)
    bw_warped = image_warp(backward_flow, forward_gt)
    bw_warped_gt = image_warp(backward_gt, forward_gt)

    def lsq(x):
        return torch.sum(x ** 2, dim=-1, keepdim=True)

    diff_fw = bw_warped + forward_flow
    diff_fw_gt = bw_warped_gt + forward_gt
    diff_bw = backward_flow + fw_warped
    diff_bw_gt = backward_gt + fw_warped_gt

    occ_fw = (lsq(diff_fw_gt) > 0.01 * (lsq(forward_gt) + lsq(bw_warped_gt))
              + 0.5).to(forward_flow.dtype)
    occ_bw = (lsq(diff_bw_gt) > 0.01 * (lsq(backward_gt) + lsq(fw_warped_gt))
              + 0.5).to(forward_flow.dtype)
    mask_fw = mask_fw * (1 - occ_fw)
    mask_bw = mask_bw * (1 - occ_bw)
    return fb_weight * (charbonnier(diff_fw, mask_fw)
                        + charbonnier(diff_bw, mask_bw))
