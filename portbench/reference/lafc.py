"""LAFC and LAFC-single of the plain reference: ``fgt_tpu_torch/models/
lafc.py`` and ``lafc_single.py`` at commit ac5eac9, vanilla convolutions
only (the configurations' ``conv_type``). Module names are the port's;
both take the port's layouts (flows [B, T, H, W, 2] or [B, H, W, 2]).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.blocks import (Pad, VanillaConv, VanillaDeconv,
                                        leaky_relu_02)


class P3DBlock(nn.Module):
    def __init__(self, cin, cout, k, stride, padding, bias,
                 use_residual=False):
        super().__init__()
        self.conv1 = VanillaConv(cin, cout, (1, k, k), (1, stride, stride),
                                 (0, padding, padding), bias=bias, rank=3)
        self.conv2 = VanillaConv(cout, cout, (3, 1, 1), 1, (1, 0, 0),
                                 bias=bias, rank=3)
        self.use_residual = use_residual

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.use_residual else y


class EdgeDetection(nn.Module):
    def __init__(self, in_ch: int = 2, mid: int = 16, out_ch: int = 1):
        super().__init__()
        self.projection = VanillaConv(in_ch, mid, 3, 1, 1)
        self.mid_layer_1 = VanillaConv(mid, mid, 3, 1, 1)
        self.mid_layer_2 = VanillaConv(mid, mid, 3, 1, 1, activation=None)
        self.out_layer = VanillaConv(mid, out_ch, 1, 1, 0, activation=None)

    def forward(self, flow):
        proj = self.projection(flow)
        e = self.mid_layer_2(self.mid_layer_1(proj))
        return torch.sigmoid(self.out_layer(F.leaky_relu(proj + e, 0.01)))


def _keys(cfg: dict) -> tuple:
    return (cfg.get("cnum", 48), bool(cfg.get("use_bias", 1)),
            bool(cfg.get("use_residual", 1)), cfg.get("num_flows", 3),
            cfg.get("in_channel", 3), bool(cfg.get("PASSMASK", 1)),
            cfg.get("resBlocks", 1))


class P3DNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        nf, bias, residual, t, cin, self.pass_mask, nres = _keys(cfg)
        conv, deconv = VanillaConv, VanillaDeconv
        self.encoder2 = nn.Sequential(
            Pad(2), P3DBlock(cin, nf, 5, 1, 0, bias),
            P3DBlock(nf, nf * 2, 3, 2, 1, bias))
        self.encoder4 = nn.Sequential(
            P3DBlock(nf * 2, nf * 2, 3, 1, 1, bias, residual),
            P3DBlock(nf * 2, nf * 4, 3, 2, 1, bias))
        self.res_blocks = nn.Sequential(*[
            P3DBlock(nf * 4, nf * 4, 3, 1, 1, bias, True)
            for _ in range(nres)])

        def condense(c):
            return conv(c, c, (t, 1, 1), 1, 0, bias=bias, rank=3)
        self.condense2 = condense(nf * 2)
        self.condense4_pre = condense(nf * 4)
        self.condense4_post = condense(nf * 4)
        self.middle = nn.Sequential(*[
            conv(nf * 4, nf * 4, 3, 1, d, dilation=d, bias=bias)
            for d in (8, 4, 2, 1)])
        self.decoder2 = nn.Sequential(
            deconv(nf * 8, nf * 2, 3, 1, 1, bias=bias),
            conv(nf * 2, nf * 2, 3, 1, 1, bias=bias),
            conv(nf * 2, nf * 2, 3, 1, 1, bias=bias))
        self.decoder = nn.Sequential(
            deconv(nf * 4, nf, 3, 1, 1, bias=bias),
            conv(nf, nf // 2, 3, 1, 1, bias=bias),
            conv(nf // 2, 2, 3, 1, 1, bias=bias, activation=None))
        self.edgeDetector = EdgeDetection(2, 16, 1)

    def forward(self, flows, masks):
        x = torch.cat([flows, masks], dim=1) if self.pass_mask else flows
        e2 = self.encoder2(x)
        e4 = self.encoder4(e2)
        c_e2_pre = self.condense2(e2)[:, :, 0]
        c_e4_pre = self.condense4_pre(e4)[:, :, 0]
        e4 = self.res_blocks(e4)
        c_e4_post = self.condense4_post(e4)[:, :, 0]
        m = self.middle(c_e4_post)
        y = self.decoder2(torch.cat([m, c_e4_pre], dim=1))
        return self.decoder(torch.cat([y, c_e2_pre], dim=1))


class LAFC(nn.Module):
    """flows [B, T, H, W, 2], masks [B, T, H, W, 1] -> flow [B, H, W, 2]."""

    def __init__(self, config: dict):
        super().__init__()
        self.net = P3DNet(config)

    def forward(self, flows, masks):
        dt = self.net.middle[0].featureConv.weight.dtype
        out = self.net(flows.permute(0, 4, 1, 2, 3).to(dt),
                       masks.permute(0, 4, 1, 2, 3).to(dt))
        return out.permute(0, 2, 3, 1)


class ResidualBlockNoBN(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv2 = nn.Conv2d(nf, nf, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(leaky_relu_02(self.conv1(x)))


class P3DNetSingle(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        nf, bias, _, _, cin, self.pass_mask, nres = _keys(cfg)

        def conv(ci, co, s=1, d=1, **kw):
            return VanillaConv(ci, co, 3, s, d, dilation=d, bias=bias, **kw)
        self.encoder2 = nn.Sequential(
            Pad(2), VanillaConv(cin, nf, 5, 1, 0, bias=bias),
            conv(nf, nf * 2, s=2))
        self.encoder4 = nn.Sequential(conv(nf * 2, nf * 2),
                                      conv(nf * 2, nf * 4, s=2))
        self.res_blocks = nn.Sequential(*[ResidualBlockNoBN(nf * 4)
                                          for _ in range(nres)])
        self.middle = nn.Sequential(*[conv(nf * 4, nf * 4, d=d)
                                      for d in (8, 4, 2, 1)])
        self.decoder2 = nn.Sequential(
            VanillaDeconv(nf * 8, nf * 2, 3, 1, 1, bias=bias),
            conv(nf * 2, nf * 2), conv(nf * 2, nf * 2))
        self.decoder = nn.Sequential(
            VanillaDeconv(nf * 4, nf, 3, 1, 1, bias=bias),
            conv(nf, nf // 2), conv(nf // 2, 2))   # activated, as the port's
        self.edgeDetector = EdgeDetection(2, 16, 1)

    def forward(self, flow, mask):
        x = torch.cat([flow, mask], dim=1) if self.pass_mask else flow
        e2 = self.encoder2(x)
        e4 = self.encoder4(e2)
        y = self.middle(self.res_blocks(e4))
        y = self.decoder2(torch.cat([y, e4], dim=1))
        return self.decoder(torch.cat([y, e2], dim=1))


class LAFCSingle(nn.Module):
    """flow [B, H, W, 2], mask [B, H, W, 1] -> flow [B, H, W, 2]."""

    def __init__(self, config: dict):
        super().__init__()
        self.net = P3DNetSingle(config)

    def forward(self, flow, mask):
        dt = self.net.middle[0].featureConv.weight.dtype
        out = self.net(flow.permute(0, 3, 1, 2).to(dt),
                       mask.permute(0, 3, 1, 2).to(dt))
        return out.permute(0, 2, 3, 1)
