"""LAFC-single — 2D single-flow completion network in PyTorch;
counterpart of ``fgt_tpu/models/lafc_single.py`` (reference
LAFC/models/lafc_single.py:9-112). FGT training runs it frozen as the
flow oracle (reference FGT/networks/network.py:43-49).

The LAFC topology with every P3D block replaced by a plain 2D conv, one
flow in, one flow out. Module names follow the reference tree
(``net.encoder2.1.featureConv``, ``net.res_blocks.0.conv1`` ...).

Reference quirk kept: the last decoder conv keeps the default
LeakyReLU(0.2), so the predicted flow passes through it (the multi-flow
LAFC's flow head is linear).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fgt_tpu_torch.models.lafc import EdgeDetection, _Pad
from fgt_tpu_torch.ops.conv_blocks import (VanillaConv, VanillaDeconv,
                                           init_kaiming, leaky_relu_02)


class ResidualBlockNoBN(nn.Module):
    """Conv-LReLU-Conv, residual, no norm (reference
    FGT/models/utils/reconstructionLayers.py:27-48)."""

    def __init__(self, nf: int):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv2 = nn.Conv2d(nf, nf, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(leaky_relu_02(self.conv1(x)))


class P3DNetSingle(nn.Module):
    """The LAFC-single trunk (``conv_type: vanilla``, no edge input)."""

    def __init__(self, cfg: dict):
        super().__init__()
        nf = cfg.get("cnum", 48)
        bias = bool(cfg.get("use_bias", 1))
        cin = cfg.get("in_channel", 3)
        self.pass_mask = bool(cfg.get("PASSMASK", 1))

        def conv(ci, co, s=1, d=1, **kw):
            return VanillaConv(ci, co, 3, s, d, dilation=d, bias=bias, **kw)

        self.encoder2 = nn.Sequential(
            _Pad(2), VanillaConv(cin, nf, 5, 1, 0, bias=bias),
            conv(nf, nf * 2, s=2))
        self.encoder4 = nn.Sequential(conv(nf * 2, nf * 2),
                                      conv(nf * 2, nf * 4, s=2))
        self.res_blocks = nn.Sequential(*[
            ResidualBlockNoBN(nf * 4)
            for _ in range(cfg.get("resBlocks", 1))])
        self.middle = nn.Sequential(*[conv(nf * 4, nf * 4, d=d)
                                      for d in (8, 4, 2, 1)])
        self.decoder2 = nn.Sequential(
            VanillaDeconv(nf * 8, nf * 2, 3, 1, 1, bias=bias),
            conv(nf * 2, nf * 2), conv(nf * 2, nf * 2))
        self.decoder = nn.Sequential(
            VanillaDeconv(nf * 4, nf, 3, 1, 1, bias=bias),
            conv(nf, nf // 2), conv(nf // 2, 2))   # quirk: activated head
        self.edgeDetector = EdgeDetection(2, 16, 1)

    def forward(self, flow, mask, with_edge: bool = True):
        """flow [B, 2, H, W], mask [B, 1, H, W] -> (flow [B, 2, H, W],
        edge [B, 1, H, W] or None)."""
        x = torch.cat([flow, mask], dim=1) if self.pass_mask else flow
        e2 = self.encoder2(x)
        e4 = self.encoder4(e2)
        y = self.middle(self.res_blocks(e4))
        y = self.decoder2(torch.cat([y, e4], dim=1))
        out = self.decoder(torch.cat([y, e2], dim=1))
        edge = self.edgeDetector(out) if with_edge else None
        return out, edge


class Model(nn.Module):
    """Reference-compatible wrapper taking the JAX package's layouts:
    flow [B, H, W, 2], mask [B, H, W, 1] -> (flow [B, H, W, 2],
    edge [B, H, W, 1] or None)."""

    def __init__(self, config: dict):
        super().__init__()
        self.net = P3DNetSingle(config)

    def forward(self, flow, mask, with_edge: bool = True):
        dt = self.net.middle[0].featureConv.weight.dtype
        out, edge = self.net(flow.permute(0, 3, 1, 2).to(dt),
                             mask.permute(0, 3, 1, 2).to(dt), with_edge)
        return (out.permute(0, 2, 3, 1),
                None if edge is None else edge.permute(0, 2, 3, 1))


def init_lafc_single(model: Model, gen: torch.Generator) -> Model:
    """Seeded He fan-in init (the JAX package's LAFC-single init)."""
    init_kaiming(model, gen, mode="fan_in")
    return model
