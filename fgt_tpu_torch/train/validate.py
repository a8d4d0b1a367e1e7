"""In-training validation on a DAVIS-style tree — counterpart of
``fgt_tpu/train/validate.py`` (reference FGT/networks/network.py:258-354,
LAFC/networks/network.py:271-373).

Protocol: the first ``num_videos`` videos, a window around pivot frame
20, masks from ``mask_root`` (or a centered square when absent),
diffusion-filled flows, PSNR / SSIM / L1 / L2 on uint8 composites
(FGT) or on the completed flows (LAFC). The models run on their own
device under ``torch.inference_mode()``, in f32 as the JAX package's
validation runs them.

Holes are {0, 1}. The JAX functions take ``rect_mask``'s {0, 255}
square as the hole weight itself, so their centered-square composites
scale the hole by 255; the port does not inherit that
(``tests/test_torch_port_validate.py``).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from fgt_tpu_torch.core import metrics as metrics_mod
from fgt_tpu_torch.core.flow_io import read_flow
from fgt_tpu_torch.core.flow_viz import flow_to_rgb
from fgt_tpu_torch.core.masks import rect_mask
from fgt_tpu_torch.data.datasets import diffusion_fill, flow_tf
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline.video_inpainting import indices_gen
from fgt_tpu_torch.train.fgt_step import norm_flows_nhwc


def _ref_index(neighbor_ids, length, ref_length):
    return [i for i in range(0, length, ref_length) if i not in neighbor_ids]


def _read_window_frames(frame_dir, width, height, ids):
    out = []
    for i in ids:
        if os.path.exists(os.path.join(frame_dir, f"{i:05d}.jpg")):
            raise ValueError(f"{frame_dir}: only PNG frames are read (no "
                             f"JPEG decoder on the GPU machine)")
        p = os.path.join(frame_dir, f"{i:05d}.png")
        if not os.path.exists(p):
            return []
        f = image_io.read_png(p)
        if f.ndim == 2:
            f = np.stack([f] * 3, axis=-1)
        out.append(image_io.resize_linear_u8(f[..., :3], height, width))
    return out


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _square(height: int, width: int, size: int) -> np.ndarray:
    return (rect_mask(height, width, size=size) > 0).astype(np.uint8)


def validate_fgt(gen: torch.nn.Module, frame_root: str,
                 flow_root: Optional[str],
                 flow_model: Optional[torch.nn.Module] = None,
                 mask_root: Optional[str] = None, num_videos: int = 10,
                 resolution=(240, 432), mask_size: int = 96,
                 pivot: int = 20, num_frames: int = 5, ref_length: int = 20,
                 save_dir: Optional[str] = None) -> dict:
    """Mean PSNR / SSIM / L1 / L2 of the generator's composites over the
    first ``num_videos`` videos. With ``flow_model`` (LAFC-single) the
    diffused flows are completed first. With ``save_dir``, one canvas
    per video (result | GT | masked input, a row per frame) is written
    as PNG (reference FGT/networks/network.py:470-491)."""
    height, width = resolution
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    device = _device_of(gen)
    videos = sorted(os.listdir(frame_root))[:num_videos]
    psnrs, ssims, l1s, l2s = [], [], [], []
    for video in videos:
        frame_dir = os.path.join(frame_root, video)
        n = len(glob.glob(os.path.join(frame_dir, "*.jpg"))) or \
            len(glob.glob(os.path.join(frame_dir, "*.png")))
        if n == 0:
            continue
        piv = min(pivot, n - 1)
        neighbor_ids = list(range(max(0, piv - num_frames // 2),
                                  min(n, piv + num_frames // 2)))
        ids = _ref_index(neighbor_ids, n, ref_length) + neighbor_ids
        frames = _read_window_frames(frame_dir, width, height, ids)
        if not frames:
            continue

        masks = []
        for i in ids:
            m = None
            if mask_root:
                p = os.path.join(mask_root, video, f"{i:05d}.png")
                if os.path.exists(p):
                    m = (image_io.read_png(p) > 127).astype(np.uint8)
                    if m.ndim == 3:
                        m = m[..., 0]
                    m = image_io.resize_nearest(m[None], height, width)[0]
            if m is None:
                m = _square(height, width, mask_size)
            masks.append(m)

        flows = []
        for k, i in enumerate(ids):
            f = None
            if flow_root:
                p = os.path.join(flow_root, video, "forward_flo",
                                 f"{min(i, n - 2):05d}.flo")
                if os.path.exists(p):
                    f = flow_tf(read_flow(p), height, width)
            if f is None:
                f = np.zeros((height, width, 2), np.float32)
            flows.append(diffusion_fill(f, masks[k]))

        frames_np = np.stack(frames).astype(np.float32) / 127.5 - 1
        masks_np = np.stack(masks).astype(np.float32)[..., None]
        flows_np = np.stack(flows).astype(np.float32)
        with torch.inference_mode():
            fl = torch.from_numpy(flows_np).to(device)
            ms = torch.from_numpy(masks_np).to(device)
            if flow_model is not None:
                fl = flow_model(fl, ms, with_edge=False)[0].float()
            fr = torch.from_numpy(frames_np).to(device)[None]
            filled = gen(fr * (1 - ms[None]), norm_flows_nhwc(fl[None]),
                         ms[None]).float()[0].cpu().numpy()
        comp = filled * masks_np + frames_np * (1 - masks_np)

        gt_u8 = ((frames_np + 1) * 127.5).clip(0, 255).astype(np.uint8)
        comp_u8 = ((comp + 1) * 127.5).clip(0, 255).astype(np.uint8)
        for t in range(gt_u8.shape[0]):
            psnrs.append(metrics_mod.psnr(comp_u8[t], gt_u8[t]))
            ssims.append(metrics_mod.ssim(comp_u8[t], gt_u8[t]))
            diff = comp_u8[t].astype(np.float64) - gt_u8[t].astype(np.float64)
            l1s.append(np.abs(diff).mean())
            l2s.append((diff ** 2).mean())
        if save_dir:
            masked_u8 = ((frames_np * (1 - masks_np) + 1) * 127.5) \
                .clip(0, 255).astype(np.uint8)
            rows = [np.concatenate([comp_u8[t], gt_u8[t], masked_u8[t]],
                                   axis=1) for t in range(gt_u8.shape[0])]
            image_io.write_png(os.path.join(save_dir, f"{video}.png"),
                               np.concatenate(rows, axis=0))
    if not psnrs:
        return {}
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
            "l1": float(np.mean(l1s)), "l2": float(np.mean(l2s))}


def validate_lafc(model: torch.nn.Module, flow_root: str,
                  num_videos: int = 10, resolution=(240, 432),
                  mask_size: int = 96, num_flows: int = 3, interval: int = 3,
                  single: bool = False, save_dir: Optional[str] = None
                  ) -> dict:
    """Flow-domain validation: the first videos' forward and backward
    flows, a centered square hole, diffusion fill, completion, then
    PSNR / SSIM of the flows' colourings and L1 / L2 of the raw flows.
    With ``save_dir``, a triptych (completed | GT | diffused input) per
    video and direction is written as PNG (reference
    LAFC/networks/network.py:481-513)."""
    height, width = resolution
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    device = _device_of(model)
    videos = sorted(os.listdir(flow_root))[:num_videos]
    agg = {"psnr": [], "ssim": [], "l1": [], "l2": []}
    for video in videos:
        for direction in ("forward_flo", "backward_flo"):
            d = os.path.join(flow_root, video, direction)
            if not os.path.isdir(d):
                continue
            files = sorted(glob.glob(os.path.join(d, "*.flo")))
            if len(files) <= num_flows:
                continue
            pivot = min(20, len(files) - 1)
            ids = indices_gen(pivot, interval, num_flows, len(files))
            mask = _square(height, width, mask_size).astype(
                np.float32)[..., None]
            flows, diffused = [], []
            for i in ids:
                f = flow_tf(read_flow(files[i]), height, width)
                flows.append(f)
                diffused.append(diffusion_fill(f, mask[..., 0]))
            gt = np.stack(flows).astype(np.float32)
            din = np.stack(diffused).astype(np.float32)
            masks = np.repeat(mask[None], len(ids), 0)
            with torch.inference_mode():
                if single:
                    f_in, m_in = din[num_flows // 2][None], \
                        masks[num_flows // 2][None]
                else:
                    f_in, m_in = din[None], masks[None]
                out = model(torch.from_numpy(f_in).to(device),
                            torch.from_numpy(m_in).to(device),
                            with_edge=False)[0]
                filled = out.float().cpu().numpy().reshape(-1, height,
                                                           width, 2)
            target = gt[num_flows // 2][None]
            comp = filled * mask + target * (1 - mask)
            m = metrics_mod.calculate_flow_metrics(comp, target)
            for k in agg:
                agg[k].append(m[k])
            if save_dir:
                trip = np.concatenate(
                    [flow_to_rgb(comp[0]), flow_to_rgb(target[0]),
                     flow_to_rgb(din[num_flows // 2])], axis=1)
                image_io.write_png(
                    os.path.join(save_dir, f"{video}_{direction}.png"),
                    (trip * 255).clip(0, 255).astype(np.uint8))
    if not agg["psnr"]:
        return {}
    return {k: float(np.mean(v)) for k, v in agg.items()}
