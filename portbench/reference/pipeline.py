"""Object removal by the plain reference, stage by stage, in the order
and at the shapes of ``inpaint`` in ``fgt_tpu_torch/pipeline/
video_inpainting.py`` (commit ac5eac9): s1 RAFT flows, s2 diffusion +
LAFC over reflect-indexed windows, s3-s5 on the host
(:mod:`portbench.reference.host`), s6 FGT over the fixed-shape windows
with the pivot-order 50/50 composite. Each stage is its own function,
so a check can start any stage from the output of the one before it.
Batches are chunked to bound memory; nothing here depends on the chunk.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.diffusion import diffuse_flows_device
from portbench.reference.fgt import FGT
from portbench.reference.host import frame_holes, propagate
from portbench.reference.lafc import LAFC
from portbench.reference.raft import RAFT


class RefModels:
    """RAFT, LAFC and FGT of the reference on ``device`` in f32, loaded
    from the same state dicts the program is given."""

    def __init__(self, device, lafc_config: dict, fgt_config: dict,
                 raft_state: dict, lafc_state: dict, fgt_state: dict,
                 raft_iters: int = 20):
        self.device = torch.device(device)
        self.raft_iters = raft_iters
        self.lafc_config = lafc_config
        self.raft, self.lafc, self.fgt = RAFT(), LAFC(lafc_config), \
            FGT(fgt_config)
        for m, st in ((self.raft, raft_state), (self.lafc, lafc_state),
                      (self.fgt, fgt_state)):
            m.load_state_dict({k: v.float() for k, v in st.items()},
                              strict=True)
            m.to(self.device).eval().requires_grad_(False)


def resize_flows(flow, out_h, out_w):
    b, h, w, _ = flow.shape
    if (h, w) == (out_h, out_w):
        return flow
    out = F.interpolate(flow.permute(0, 3, 1, 2), size=(out_h, out_w),
                        mode="bilinear", align_corners=False, antialias=True)
    scale = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype,
                         device=flow.device)
    return out.permute(0, 2, 3, 1) * scale


@torch.no_grad()
def s1_flows(m: RefModels, frames255: np.ndarray, pair_chunk: int = 3):
    """Forward and backward flows [N-1, H, W, 2] f32 of frames
    [N, H, W, 3] in [0, 255] (RAFT at 2x under 350 px)."""
    n, h, w = frames255.shape[:3]
    fh, fw = (2 * h, 2 * w) if h < 350 else (h, w)
    u8 = torch.from_numpy(np.clip(np.round(frames255), 0, 255)
                          .astype(np.uint8)).to(m.device)
    feats = []
    for s in range(0, n, 4):
        fr = u8[s:s + 4].float()
        if (h, w) != (fh, fw):
            fr = F.interpolate(fr.permute(0, 3, 1, 2), size=(fh, fw),
                               mode="bilinear", align_corners=False
                               ).permute(0, 2, 3, 1)
        feats.append(m.raft.encode(fr))
    fmap, net, inp = (torch.cat(p) for p in zip(*feats))
    ar = torch.arange(n - 1, device=m.device)
    src, dst = torch.cat([ar, ar + 1]), torch.cat([ar + 1, ar])
    outs = []
    for s in range(0, src.shape[0], pair_chunk):
        i, j = src[s:s + pair_chunk], dst[s:s + pair_chunk]
        up = m.raft.refine(fmap[i], fmap[j], net[i], inp[i], m.raft_iters)
        outs.append(resize_flows(up.float(), h, w))
    flows = torch.cat(outs)
    return flows[:n - 1], flows[n - 1:]


def indices_gen(pivot, interval, frames, t):
    out = []
    for i in range(-(frames // 2), frames // 2 + 1):
        idx = pivot + interval * i
        if idx < 0:
            idx = abs(idx)
        if idx > t - 1:
            idx = 2 * (t - 1) - idx
        out.append(idx)
    return out


def flow_masks(masks: np.ndarray, dilates: int = 8) -> np.ndarray:
    """s2's hole: each frame's hole dilated ``dilates`` times."""
    return frame_holes(masks, dilates)


@torch.no_grad()
def complete_flows(m: RefModels, flows: torch.Tensor, masks: torch.Tensor,
                   chunk: int = 8):
    """Diffusion, then LAFC over reflect-indexed windows composited at
    the pivot. flows [T, H, W, 2] f32; masks [T, H, W] {0, 1}."""
    nf, iv = m.lafc_config["num_flows"], m.lafc_config.get("flow_interval", 3)
    t, h, w, _ = flows.shape
    diffused = diffuse_flows_device(flows, masks)
    ids = torch.tensor([indices_gen(i, iv, nf, t) for i in range(t)],
                       device=flows.device)
    mf = masks.float()
    outs = []
    for s in range(0, t, chunk):
        ib = ids[s:s + chunk]
        b = ib.shape[0]
        wf = diffused[ib.reshape(-1)].reshape(b, nf, h, w, 2)
        wm = mf[ib.reshape(-1)].reshape(b, nf, h, w, 1)
        out = m.lafc(wf, wm).float()
        piv = ib[:, nf // 2]
        pm = mf[piv][..., None]
        outs.append(out * pm + flows[piv] * (1 - pm))
    return torch.cat(outs)


def s2_flows(m: RefModels, flows_f, flows_b, masks: np.ndarray,
             dilates: int = 8):
    """s2 on both directions; masks [N, H, W] holes (before dilation)."""
    fm = torch.from_numpy(flow_masks(masks, dilates).astype(np.uint8)).to(
        m.device)
    return (complete_flows(m, flows_f, fm[:-1]),
            complete_flows(m, flows_b, fm[1:]))


def get_ref_index(f, neighbor_ids, length, ref_length, num_ref):
    ref_index = []
    if num_ref == -1:
        for i in range(0, length, ref_length):
            if i not in neighbor_ids:
                ref_index.append(i)
    else:
        start = max(0, f - ref_length * (num_ref // 2))
        end = min(length, f + ref_length * (num_ref // 2))
        for i in range(start, end + 1, ref_length):
            if i not in neighbor_ids:
                if len(ref_index) > num_ref:
                    break
                ref_index.append(i)
    return ref_index


def fgt_window_ids(n, neighbor_stride=5, step=10, num_ref=-1):
    t_n = min(n, 2 * neighbor_stride + 1)
    neigh_all, refs_all = [], []
    for f in range(0, n, neighbor_stride):
        start = int(np.clip(f - neighbor_stride, 0, n - t_n))
        neigh_all.append(list(range(start, start + t_n)))
        refs_all.append(get_ref_index(f, neigh_all[-1], n, step, num_ref))
    n_ref = max(len(r) for r in refs_all)
    for neigh, refs in zip(neigh_all, refs_all):
        extra = (i for i in range(n) if i not in refs and i not in neigh)
        while len(refs) < n_ref:
            refs.append(next(extra, refs[-1] if refs else neigh[-1]))
    return np.asarray([a + b for a, b in zip(neigh_all, refs_all)],
                      np.int64), t_n


def norm_flows(flows):
    n, h, w, c = flows.shape
    fmax = flows.reshape(n, h * w, c).amax(dim=1)[:, None, None, :]
    return flows / torch.where(fmax == 0, torch.ones_like(fmax), fmax)


@torch.no_grad()
def s6_fgt(m: RefModels, video_u8: torch.Tensor, masks_u8: torch.Tensor,
           flows_f: torch.Tensor, window_chunk: int = 2):
    """FGT over the fixed windows; video_u8 [N, H, W, 3] (the rounded
    Poisson frames), masks_u8 [N, H, W] (pixels left), flows_f
    [N-1, H, W, 2] completed forward flows. Returns u8 [N, H, W, 3]."""
    n, h, w, _ = video_u8.shape
    ids_np, t_n = fgt_window_ids(n)
    ids = torch.from_numpy(ids_np).to(video_u8.device)
    t = ids_np.shape[1]
    flows = norm_flows(torch.cat([flows_f, flows_f[-1:]]).float())
    mf = masks_u8.float()[..., None]
    vf = video_u8.float()
    outs = []
    for s in range(0, ids.shape[0], window_chunk):
        ib = ids[s:s + window_chunk]
        b = ib.shape[0]
        flat = ib.reshape(-1)
        fr = video_u8[flat].float().reshape(b, t, h, w, 3) / 255.0 * 2 - 1
        mk = masks_u8[flat].float().reshape(b, t, h, w, 1)
        fl = flows[flat].reshape(b, t, h, w, 2)
        out = m.fgt(fr * (1 - mk), fl, mk)
        outs.append(((out.float() + 1.0) / 2.0 * 255.0).to(torch.uint8))
    out_u8 = torch.cat(outs)
    comp = torch.zeros(n, h, w, 3, dtype=torch.float32,
                       device=video_u8.device)
    seen = torch.zeros(n, dtype=torch.bool, device=video_u8.device)
    for j in range(ids.shape[0]):
        nb = ids[j, :t_n]
        mj = mf[nb]
        new = out_u8[j, :t_n].float() * mj + vf[nb] * (1 - mj)
        sj = seen[nb][:, None, None, None]
        comp[nb] = torch.where(sj, 0.5 * comp[nb] + 0.5 * new, new)
        seen[nb] = True
    return comp.to(torch.uint8)


def s3_s6(m: RefModels, frames255: np.ndarray, masks: np.ndarray,
          comp_f: torch.Tensor, comp_b: torch.Tensor, frame_dilates: int = 0):
    """Host propagation and Poisson, then FGT, from completed flows, on
    the holes dilated ``frame_dilates`` times. Returns (u8 [N, H, W, 3],
    the pixels left for FGT [N, H, W] bool)."""
    blends, left = propagate(frames255, frame_holes(masks, frame_dilates),
                             comp_f.cpu().numpy(), comp_b.cpu().numpy())
    u8 = np.clip(np.round(blends * 255.0), 0, 255).astype(np.uint8)
    return s6_fgt(m, torch.from_numpy(u8).to(m.device),
                  torch.from_numpy(left.astype(np.uint8)).to(m.device),
                  comp_f).cpu().numpy(), left
