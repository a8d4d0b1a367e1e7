"""RAFT (big) of the plain reference: ``fgt_tpu_torch/models/raft.py`` at
commit ac5eac9, its big variant only. Its correlation taps are those of
the port's ``corr="fused"`` path (kernel K1: f1 dotted with the corners
of an average-pooled feature pyramid, combined bilinearly, zero outside)
computed as the original RAFT's CorrBlock computes them: an all-pairs
volume, average-pooled, sampled by ``grid_sample``. Module names are the
port's.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.blocks import FrozenBatchNorm

CORR_LEVELS = 4


class InstanceNorm(nn.Module):
    def forward(self, x):
        return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


def _norm(kind: str, channels: int) -> nn.Module:
    if kind == "none":
        return nn.Identity()
    return FrozenBatchNorm(channels) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride))
            self.norm3 = _norm(norm, planes)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        in_planes = 64
        for i, (dim, stride) in enumerate(((64, 1), (96, 2), (128, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(in_planes, dim, norm, stride),
                ResidualBlock(dim, dim, norm, 1)))
            in_planes = dim
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    def __init__(self, radius: int = 4):
        super().__init__()
        self.convc1 = nn.Conv2d(CORR_LEVELS * (2 * radius + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in ("z", "r", "q"):
                setattr(self, f"conv{g}{suffix}",
                        nn.Conv2d(cin, hidden_dim, k, padding=p))

    def forward(self, h, x):
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden_dim: int = 128, context_dim: int = 128,
                 radius: int = 4):
        super().__init__()
        self.encoder = BasicMotionEncoder(radius)
        self.gru = SepConvGRU(hidden_dim, 128 + context_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow, with_mask: bool = True):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head(net)
        if not with_mask:
            return net, None, delta
        return net, 0.25 * self.mask(net), delta


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4) -> list:
    """The all-pairs correlation volume f1·f2 / sqrt(C) of each pair
    ([B·H·W, 1, H, W] per level), average-pooled 2x2 a level (floor on
    odd sizes), as the original RAFT's CorrBlock builds it. Pooling the
    volume is pooling the features: the same taps as K1's pooled-feature
    pyramid."""
    b, h, w, c = fmap1.shape
    corr = torch.einsum("bpc,bqc->bpq", fmap1.reshape(b, h * w, c),
                        fmap2.reshape(b, h * w, c)) / math.sqrt(c)
    levels = [corr.reshape(b * h * w, 1, h, w)]
    for _ in range(num_levels - 1):
        levels.append(F.avg_pool2d(levels[-1], 2, 2))
    return levels


def lookup_corr(pyramid: list, coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """Taps [B, H, W, levels·(2r+1)²] at ``coords / 2^level`` + (dx, dy)
    for dx, dy in [-r, r] (dx major), sampled bilinearly with zeros
    outside the volume (``grid_sample``; pixel x at (2x + 1) / W - 1)."""
    b, h, w, _ = coords.shape
    n = b * h * w
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=coords.device,
                     dtype=torch.float32)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[2:]
        c = coords.reshape(n, 1, 1, 2) / 2 ** lvl
        x = c[..., 0] + d[:, None]                     # [n, k(dx), 1]
        y = c[..., 1] + d[None, :]                     # [n, 1, k(dy)]
        grid = torch.stack([((2 * x + 1) / wl - 1).expand(n, k, k),
                            ((2 * y + 1) / hl - 1).expand(n, k, k)], dim=-1)
        taps = F.grid_sample(corr, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=False)
        out.append(taps.reshape(n, k * k))
    return torch.cat(out, dim=1).reshape(b, h, w, -1)


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(b, h, w, 2)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor):
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = torch.sum(m * up, dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden_dim, self.context_dim = 128, 128
        self.corr_radius = 4
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(256, "batch")
        self.update_block = BasicUpdateBlock(128, 128, 4)

    @property
    def dtype(self) -> torch.dtype:
        return self.fnet.conv1.weight.dtype

    def encode(self, images: torch.Tensor):
        """Frames [B, H, W, 3] in [0, 255] -> (fmap, net, inp), NHWC."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = 2 * (x / 255.0) - 1.0
        fmap = self.fnet(x)
        cnet = self.cnet(x)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = F.relu(cnet[:, self.hidden_dim:])
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
        return nhwc(fmap), nhwc(net), nhwc(inp)

    def refine(self, fmap1, fmap2, net, inp, iters: int):
        """Returns the x8 upsampled flow [B, 8·H8, 8·W8, 2]."""
        dt = self.dtype
        pyramid = corr_pyramid(fmap1, fmap2, CORR_LEVELS)
        b, h8, w8, _ = fmap1.shape
        coords0 = coords_grid(b, h8, w8, fmap1.device)
        coords1 = coords0.clone()
        net = net.permute(0, 3, 1, 2)
        inp = inp.permute(0, 3, 1, 2)
        mask = None
        for i in range(iters):
            taps = lookup_corr(pyramid, coords1,
                               self.corr_radius).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).permute(0, 3, 1, 2).to(dt)
            net, mask, delta = self.update_block(
                net, inp, taps.to(dt), flow, with_mask=i == iters - 1)
            coords1 = coords1 + delta.permute(0, 2, 3, 1).float()
        up = upsample_flow_convex((coords1 - coords0).permute(0, 3, 1, 2),
                                  mask.float())
        return up.permute(0, 2, 3, 1)
