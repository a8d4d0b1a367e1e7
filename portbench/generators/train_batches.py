"""GAN training batches made on the card from a ``torch.Generator``
seeded by the run's seed: ``make`` returns an object whose ``next()``
gives {frames [B, T, H, W, 3] in [-1, 1], masks [B, T, H, W, 1] in
{0, 1}, flows [B, T, H, W, 2]}, a fresh draw each call with no host
synchronisation: ``batch`` x ``frames`` frames of smoothed noise panning
``pan_px`` a frame, masks drawn from a pool of ``pool`` holes made at
set-up by ``portbench/holes/<hole.kind>.py``, and smooth random flows of
``flow_amp`` px interpolated from a ``flow_nodes`` grid."""

import numpy as np

from portbench import common


class TrainBatches:
    def __init__(self, mix: dict, seed: int, device):
        import torch

        self.torch = torch
        self.mix = mix
        self.b, self.t = mix["batch"], mix["frames"]
        self.h, self.w = mix["height"], mix["width"]
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device).manual_seed(seed)
        hole = mix["hole"]
        shape = common.load_module("holes", hole["kind"]).masks
        pool = [shape(hole, i, self.t, self.h, self.w, mix["pan_px"])
                for i in range(mix["pool"])]
        self.masks = torch.from_numpy(np.stack(pool)).to(
            self.device, torch.float32)[..., None]

    def next(self) -> dict:
        torch, F = self.torch, self.torch.nn.functional
        b, t, h, w, pan = self.b, self.t, self.h, self.w, self.mix["pan_px"]
        g, dev = self.gen, self.device
        noise = torch.rand(b, 3, h + 8, w + pan * t + 8, device=dev,
                           generator=g)
        base = F.avg_pool2d(noise, 9, stride=1)
        frames = torch.stack([base[:, :, :h, pan * i:pan * i + w]
                              for i in range(t)], dim=1)
        frames = frames.permute(0, 1, 3, 4, 2) * 2 - 1
        lo = (frames.amin(dim=(1, 2, 3, 4), keepdim=True),
              frames.amax(dim=(1, 2, 3, 4), keepdim=True))
        frames = (frames - lo[0]) / (lo[1] - lo[0]) * 2 - 1
        pick = torch.randint(0, self.masks.shape[0], (b,), device=dev,
                             generator=g)
        masks = self.masks[pick]
        nodes = self.mix["flow_nodes"]
        field = self.mix["flow_amp"] * torch.randn(
            b * t, 2, *nodes, device=dev, generator=g)
        flows = F.interpolate(field, size=(h, w), mode="bilinear",
                              align_corners=True)
        flows = flows.permute(0, 2, 3, 1).reshape(b, t, h, w, 2)
        return {"frames": frames.contiguous(), "masks": masks.contiguous(),
                "flows": flows.contiguous()}


def make(mix: dict, seed: int, device) -> TrainBatches:
    return TrainBatches(mix, seed, device)
