"""LAFC — local-aggregation flow completion network (P3D) in PyTorch;
counterpart of ``fgt_tpu/models/lafc.py``.

Module names follow the reference LAFC/models/lafc.py tree
(``net.encoder2.1.conv1.featureConv`` ...). Inside, tensors are NCDHW /
NCHW; :class:`Model` takes the JAX package's ``[B, T, H, W, C]`` flows and
masks and returns ``([B, H, W, 2] flow, [B, H, W, 1] edge)``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from fgt_tpu_torch.ops.conv_blocks import (conv_classes, init_kaiming,
                                           replication_pad,
                                           require_buildable)


def lafc_keys(cfg: dict, model: str = "LAFC") -> dict:
    """The keys of JAX ``LAFCConfig.from_dict`` that the port's LAFC and
    LAFC-single read, the reference names winning over their aliases
    (``PASSMASK`` over ``pass_mask``, ``resBlocks`` over
    ``res_blocks``), and ``conv_type``. A ``norm`` is checked and
    ignored, as ``LAFCConfig`` has none (every block gets no norm);
    raises where :func:`require_buildable` does."""
    conv_type, _ = require_buildable(cfg, model)
    get = cfg.get
    return {"conv_type": conv_type, "cnum": get("cnum", 48), "in_channel": get("in_channel", 3),
            "num_flows": get("num_flows", 3),
            "use_bias": bool(get("use_bias", 1)),
            "use_residual": bool(get("use_residual", 1)),
            "pass_mask": bool(get("PASSMASK", get("pass_mask", 1))),
            "res_blocks": get("resBlocks", get("res_blocks", 1))}


class P3DBlock(nn.Module):
    """(1, k, k) spatial conv then (3, 1, 1) temporal conv, both with
    leaky ReLU, optional residual (reference lafc.py:108-125); ``conv``
    is the conv_type's block class."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, padding: int,
                 bias: bool, use_residual: bool = False, conv=None):
        super().__init__()
        conv = conv or conv_classes["vanilla"][0]
        self.conv1 = conv(cin, cout, (1, k, k), (1, stride, stride),
                          (0, padding, padding), bias=bias, rank=3)
        self.conv2 = conv(cout, cout, (3, 1, 1), 1, (1, 0, 0), bias=bias,
                          rank=3)
        self.use_residual = use_residual

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return x + y if self.use_residual else y


class EdgeDetection(nn.Module):
    """Flow -> edge probability head (reference lafc.py:128-148)."""

    def __init__(self, in_ch: int = 2, mid: int = 16, out_ch: int = 1,
                 conv=None):
        super().__init__()
        conv = conv or conv_classes["vanilla"][0]
        self.projection = conv(in_ch, mid, 3, 1, 1)
        self.mid_layer_1 = conv(mid, mid, 3, 1, 1)
        self.mid_layer_2 = conv(mid, mid, 3, 1, 1, activation=None)
        self.out_layer = conv(mid, out_ch, 1, 1, 0, activation=None)

    def forward(self, flow):
        proj = self.projection(flow)
        e = self.mid_layer_2(self.mid_layer_1(proj))
        e = F.leaky_relu(proj + e, 0.01)
        return torch.sigmoid(self.out_layer(e))


class _Pad(nn.Module):
    """Edge replication of the two trailing dims, H and W, of an NCHW or
    NCDHW tensor (reference ReplicationPad2d(p) /
    ReplicationPad3d((p, p, p, p, 0, 0)))."""

    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return replication_pad(x, self.pad)


class P3DNet(nn.Module):
    """The LAFC trunk (reference lafc.py:18-105) with ``use_edges: 0``;
    every conv (P3D, condense, middle, decoders, edge head) is the
    ``conv_type``'s block; ``cfg`` is read by :func:`lafc_keys`."""

    def __init__(self, cfg: dict):
        super().__init__()
        c = lafc_keys(cfg)
        nf, bias, residual = c["cnum"], c["use_bias"], c["use_residual"]
        t, cin = c["num_flows"], c["in_channel"]
        conv, deconv = conv_classes[c["conv_type"]]
        self.pass_mask = c["pass_mask"]
        self.encoder2 = nn.Sequential(
            _Pad(2),
            P3DBlock(cin, nf, 5, 1, 0, bias, conv=conv),
            P3DBlock(nf, nf * 2, 3, 2, 1, bias, conv=conv))
        self.encoder4 = nn.Sequential(
            P3DBlock(nf * 2, nf * 2, 3, 1, 1, bias, residual, conv),
            P3DBlock(nf * 2, nf * 4, 3, 2, 1, bias, conv=conv))
        self.res_blocks = nn.Sequential(*[
            P3DBlock(nf * 4, nf * 4, 3, 1, 1, bias, True, conv)
            for _ in range(c["res_blocks"])])

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
        self.edgeDetector = EdgeDetection(2, 16, 1, conv)

    def forward(self, flows, masks, with_edge: bool = True):
        """flows [B, 2, T, H, W], masks [B, 1, T, H, W] -> (flow
        [B, 2, H, W], edge [B, 1, H, W] or None)."""
        x = torch.cat([flows, masks], dim=1) if self.pass_mask else flows
        e2 = self.encoder2(x)
        e4 = self.encoder4(e2)
        c_e2_pre = self.condense2(e2)[:, :, 0]
        c_e4_pre = self.condense4_pre(e4)[:, :, 0]
        e4 = self.res_blocks(e4)
        c_e4_post = self.condense4_post(e4)[:, :, 0]
        m = self.middle(c_e4_post)
        y = self.decoder2(torch.cat([m, c_e4_pre], dim=1))
        out = self.decoder(torch.cat([y, c_e2_pre], dim=1))
        edge = self.edgeDetector(out) if with_edge else None
        return out, edge


class Model(nn.Module):
    """Reference-compatible wrapper taking the JAX package's layouts:
    flows [B, T, H, W, 2], masks [B, T, H, W, 1] -> (flow [B, H, W, 2],
    edge [B, H, W, 1] or None)."""

    def __init__(self, config: dict):
        super().__init__()
        self.net = P3DNet(config)

    def forward(self, flows, masks, with_edge: bool = True):
        dt = self.net.middle[0].featureConv.weight.dtype
        out, edge = self.net(flows.permute(0, 4, 1, 2, 3).to(dt),
                             masks.permute(0, 4, 1, 2, 3).to(dt), with_edge)
        return (out.permute(0, 2, 3, 1),
                None if edge is None else edge.permute(0, 2, 3, 1))


def init_lafc(model: Model, gen: torch.Generator) -> Model:
    """Seeded He fan-in init (the JAX package's LAFC init)."""
    init_kaiming(model, gen, mode="fan_in")
    return model
