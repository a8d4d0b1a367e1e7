"""RAFT optical flow (big variant) in PyTorch — counterpart of
``fgt_tpu/models/raft.py``.

Module names follow the reference RAFT/raft.py tree (``fnet``, ``cnet``,
``update_block.{encoder,gru,flow_head,mask}``), so reference checkpoints
load as they are and ``convert.weights.raft_mapping`` bridges to the JAX
tree. Inside, tensors are NCHW; ``encode``/``refine`` keep the JAX
package's NHWC layout at their boundary.

``encode`` runs fnet + cnet once per frame; ``refine`` runs the GRU loop
over precomputed features. Its correlation comes from one of two paths,
each set up once per call:

* ``corr="fused"`` (default): kernel K1 (:mod:`fgt_tpu_torch.ops.corr_fused`)
  dots f1 with the corners of a pooled feature pyramid;
* ``corr="pyramid"``: the reference all-pairs pyramid
  (:mod:`fgt_tpu_torch.ops.corr_lookup`), looked up by kernel K3.

``forward`` is ``RAFT.__call__`` of the JAX package on the pyramid path.
In test mode the 576-channel upsample-mask head runs on the final
iteration only.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fgt_tpu_torch.ops.corr_fused import build_fmap_pyramid, lookup_corr_fused
from fgt_tpu_torch.ops.corr_lookup import (build_corr_pyramid,
                                           lookup_corr_pyramid)


HIDDEN_DIM = 128      # GRU state
CONTEXT_DIM = 128     # context features
CORR_LEVELS = 4
CORR_RADIUS = 4


class FrozenBatchNorm2d(nn.Module):
    """Inference batch norm on running statistics; state_dict keys are
    the reference's weight/bias/running_mean/running_var."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + shift[None, :, None, None]


class InstanceNorm(nn.Module):
    """torch InstanceNorm2d(affine=False, eps=1e-5), computed in f32."""

    def forward(self, x):
        return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


def _norm(kind: str, channels: int) -> nn.Module:
    return FrozenBatchNorm2d(channels) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm: str, stride: int = 1):
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
    """1/8-resolution feature extractor (reference extractor.py:118-192)."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        dims = ((64, 1), (96, 2), (128, 2))
        in_planes = 64
        for i, (dim, stride) in enumerate(dims):
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
    def __init__(self):
        super().__init__()
        cor_planes = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
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
    """Separable (1x5 then 5x1) ConvGRU (reference update.py:33-60)."""

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
    def __init__(self):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(HIDDEN_DIM, 128 + CONTEXT_DIM)
        self.flow_head = FlowHead(HIDDEN_DIM, 256)
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


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    """[B, H, W, 2] (x, y) pixel grid in f32."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(b, h, w, 2)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination x8 upsampling (reference raft.py:73-84).
    flow: [B, 2, H, W]; mask: [B, 576, H, W] -> [B, 2, 8H, 8W]."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = torch.sum(m * up, dim=2)                   # [b, 2, 8, 8, h, w]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(HIDDEN_DIM + CONTEXT_DIM, "batch")
        self.update_block = BasicUpdateBlock()

    @property
    def dtype(self) -> torch.dtype:
        return self.fnet.conv1.weight.dtype

    def encode(self, images: torch.Tensor):
        """Frames [B, H, W, 3] in [0, 255] -> (fmap, net, inp) NHWC at
        1/8 resolution. ``net``/``inp`` are the frame's GRU init and
        context as a flow SOURCE."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = 2 * (x / 255.0) - 1.0
        fmap = self.fnet(x)
        cnet = self.cnet(x)
        net = torch.tanh(cnet[:, :HIDDEN_DIM])
        inp = F.relu(cnet[:, HIDDEN_DIM:])
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
        return nhwc(fmap), nhwc(net), nhwc(inp)

    def refine(self, fmap1, fmap2, net, inp, iters: int, corr: str = "fused",
               corr_dtype: torch.dtype | None = None):
        """Test-mode refinement over precomputed NHWC features. ``corr``
        picks the correlation path ("fused": K1; "pyramid": all-pairs
        volumes stored in ``corr_dtype``, default the model dtype, looked
        up by K3). Returns (low-res flow [B, H8, W8, 2], upsampled flow
        [B, 8·H8, 8·W8, 2])."""
        dt = self.dtype
        if corr == "fused":
            pyramid = build_fmap_pyramid(fmap2, CORR_LEVELS, dtype=dt)
            fmap1 = fmap1.to(dt).contiguous()

            def lookup(coords):
                return lookup_corr_fused(fmap1, pyramid, coords,
                                         CORR_RADIUS).to(dt)
        elif corr == "pyramid":
            pyramid = build_corr_pyramid(fmap1, fmap2, CORR_LEVELS,
                                         dtype=corr_dtype or dt)

            def lookup(coords):   # K3 rounds its f32 taps to dt itself
                return lookup_corr_pyramid(pyramid, coords, CORR_RADIUS,
                                           out_dtype=dt)
        else:
            raise ValueError(f"unknown correlation path {corr!r}")
        b, h8, w8, _ = fmap1.shape
        coords0 = coords_grid(b, h8, w8, fmap1.device)
        coords1 = coords0.clone()
        net = net.permute(0, 3, 1, 2).to(dt)
        inp = inp.permute(0, 3, 1, 2).to(dt)
        mask = None
        for i in range(iters):
            taps = lookup(coords1).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).permute(0, 3, 1, 2).to(dt)
            net, mask, delta = self.update_block(
                net, inp, taps, flow, with_mask=i == iters - 1)
            coords1 = coords1 + delta.permute(0, 2, 3, 1).float()
        flow_lo = coords1 - coords0
        up = upsample_flow_convex(flow_lo.permute(0, 3, 1, 2), mask.float())
        return flow_lo, up.permute(0, 2, 3, 1)

    def forward(self, image1, image2, iters: int, corr: str = "pyramid",
                corr_dtype: torch.dtype | None = None):
        """``RAFT.__call__`` in test mode: frames [B, H, W, 3] in
        [0, 255]; fnet encodes both, cnet image1; refine on the all-pairs
        pyramid by default. Returns (low-res flow, upsampled flow)."""
        b = image1.shape[0]
        x = torch.cat([image1, image2]).permute(0, 3, 1, 2).to(self.dtype)
        x = 2 * (x / 255.0) - 1.0
        fmap = self.fnet(x).permute(0, 2, 3, 1).contiguous()
        cnet = self.cnet(x[:b])
        net = torch.tanh(cnet[:, :HIDDEN_DIM]).permute(0, 2, 3, 1)
        inp = F.relu(cnet[:, HIDDEN_DIM:]).permute(0, 2, 3, 1)
        return self.refine(fmap[:b], fmap[b:], net, inp, iters, corr=corr,
                           corr_dtype=corr_dtype)


def init_raft(model: RAFT, gen: torch.Generator) -> RAFT:
    """Seeded random init: He fan-out encoder convs (reference
    extractor.py:150-157), LeCun-normal update block, zero biases,
    identity batch norms."""
    from fgt_tpu_torch.ops.conv_blocks import init_kaiming

    init_kaiming(model.fnet, gen, mode="fan_out")
    init_kaiming(model.cnet, gen, mode="fan_out")
    for m in model.update_block.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (1.0 / fan_in) ** 0.5)
                m.bias.zero_()
    return model
