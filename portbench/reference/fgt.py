"""FGT generator of the plain reference: ``fgt_tpu_torch/models/fgt.py``,
``ops/attention.py`` and ``ops/ffn.py`` at commit ac5eac9, without
their tensor- and sequence-parallel paths, with TMHSA's attention as a
plain softmax (``flash_attention_plain`` of ``ops/flash_attention.py``
in f32) where the port launches kernel K2. Vanilla decoder blocks
without a norm (the configurations' ``conv_type`` and ``norm``).
Module names are the port's; takes and returns its [B, T, H, W, C]
layouts.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.blocks import (VanillaConv, VanillaDeconv,
                                        leaky_relu_02)

LN_EPS = 1e-6


def _pad_hw(x, pad_b, pad_r):
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, 0, 0, pad_r, 0, pad_b))


def softmax_attention(q, k, v, scale):
    """[..., L, ch] q, k, v -> softmax(q·kᵀ·scale)·v."""
    s = torch.einsum("...qc,...kc->...qk", q, k) * scale
    return torch.einsum("...qk,...kc->...qc", torch.softmax(s, dim=-1), v)


class TMHSA(nn.Module):
    def __init__(self, d_model: int, group_size: int, num_heads: int):
        super().__init__()
        self.group_size, self.num_heads = group_size, num_heads
        self.query_embedding = nn.Linear(d_model, d_model)
        self.key_embedding = nn.Linear(d_model, d_model)
        self.value_embedding = nn.Linear(d_model, d_model)
        self.output_linear = nn.Linear(d_model, d_model)

    def forward(self, x, t, h, w):
        bt, n, c = x.shape
        b, g, heads = bt // t, self.group_size, self.num_heads
        ch = c // heads
        wh, ww = math.ceil(h / g), math.ceil(w / g)
        pad_b, pad_r = (wh - h % wh) % wh, (ww - w % ww) % ww
        new_h, new_w = h + pad_b, w + pad_r
        win_h, win_w = new_h // g, new_w // g
        xs = _pad_hw(x.reshape(bt, h, w, c), pad_b, pad_r)

        def part(y):
            y = y.reshape(b, t, g, win_h, g, win_w, heads, ch)
            y = y.permute(0, 2, 4, 6, 1, 3, 5, 7)
            return y.reshape(b, g * g, heads, t * win_h * win_w, ch)

        q, k, v = (part(emb(xs)) for emb in (
            self.query_embedding, self.key_embedding, self.value_embedding))
        att = softmax_attention(q, k, v, 1.0 / math.sqrt(ch))
        att = att.reshape(b, g, g, heads, t, win_h, win_w, ch)
        att = att.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(
            bt, new_h, new_w, heads * ch)
        return self.output_linear(att[:, :h, :w].reshape(bt, n, c))


class FlowGuidedSWMHSA(nn.Module):
    def __init__(self, d_model, flow_d_model, window_size, global_stride,
                 num_heads):
        super().__init__()
        c, cf = d_model, flow_d_model
        self.window_size, self.num_heads = window_size, num_heads
        self.query_embedding = nn.Linear(c + cf, c)
        self.key_embedding = nn.Linear(c + cf, c)
        self.value_embedding = nn.Linear(c, c)
        self.output_linear = nn.Linear(c, c)
        self.reweightFlow = nn.Sequential(nn.Linear(c + cf, cf), nn.Sigmoid())
        self.q_norm = nn.LayerNorm(c + cf, eps=LN_EPS)
        self.k_norm = nn.LayerNorm(c + cf, eps=LN_EPS)
        self.v_norm = nn.LayerNorm(c, eps=LN_EPS)
        self.global_extract_k = nn.Conv2d(c + cf, c + cf, global_stride,
                                          stride=global_stride, groups=c + cf)
        self.global_extract_v = nn.Conv2d(c, c, global_stride,
                                          stride=global_stride, groups=c)

    def forward(self, x, f, h, w):
        bt, n, c = x.shape
        cf = f.shape[-1]
        ws, heads = self.window_size, self.num_heads
        ch = c // heads
        pad_r, pad_b = (ws - w % ws) % ws, (ws - h % ws) % ws
        new_h, new_w = h + pad_b, w + pad_r
        gh, gw = new_h // ws, new_w // ws
        xs = _pad_hw(x.reshape(bt, h, w, c), pad_b, pad_r)
        fs = _pad_hw(f.reshape(bt, h, w, cf), pad_b, pad_r)
        fs = fs * self.reweightFlow(torch.cat([xs, fs], dim=-1))
        qk = torch.cat([xs, fs], dim=-1)
        qk_c = c + cf

        def nchw_conv(conv, y):
            return conv(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        k_global = nchw_conv(self.global_extract_k, qk).reshape(bt, -1, qk_c)
        v_global = nchw_conv(self.global_extract_v, xs).reshape(bt, -1, c)

        def windows(y, cc):
            y = y.reshape(bt, gh, ws, gw, ws, cc).permute(0, 1, 3, 2, 4, 5)
            return y.reshape(bt, gh * gw, ws * ws, cc)

        q_win, x_win = windows(qk, qk_c), windows(xs, c)
        q = self.query_embedding(self.q_norm(q_win))
        k_loc = self.key_embedding(self.k_norm(q_win))
        k_glo = self.key_embedding(self.k_norm(k_global))
        v_loc = self.value_embedding(self.v_norm(x_win))
        v_glo = self.value_embedding(self.v_norm(v_global))
        nw, nloc = gh * gw, ws * ws
        q = q.reshape(bt, nw, nloc, heads, ch).float()
        k_loc = k_loc.reshape(bt, nw, nloc, heads, ch).float()
        v_loc = v_loc.reshape(bt, nw, nloc, heads, ch).float()
        k_glo = k_glo.reshape(bt, -1, heads, ch).float()
        v_glo = v_glo.reshape(bt, -1, heads, ch).float()
        scale = 1.0 / math.sqrt(ch)
        s_loc = torch.einsum("bwqhc,bwkhc->bwhqk", q, k_loc) * scale
        s_glo = torch.einsum("bwqhc,bkhc->bwhqk", q, k_glo) * scale
        probs = torch.softmax(torch.cat([s_loc, s_glo], dim=-1), dim=-1)
        att = (torch.einsum("bwhqk,bwkhc->bwqhc", probs[..., :nloc], v_loc)
               + torch.einsum("bwhqk,bkhc->bwqhc", probs[..., nloc:], v_glo))
        att = att.to(x.dtype).reshape(bt, gh, gw, ws, ws, c)
        att = att.permute(0, 1, 3, 2, 4, 5).reshape(bt, new_h, new_w, c)
        return self.output_linear(att[:, :h, :w].reshape(bt, n, c))


class FusionFeedForward(nn.Module):
    def __init__(self, d_model, mlp_ratio, kernel_size, stride, padding):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            tuple(kernel_size), tuple(stride), tuple(padding)
        hidden = self.kernel_size[0] * self.kernel_size[1] * mlp_ratio
        self.conv1 = nn.Linear(d_model, hidden)
        self.conv2 = nn.Sequential(nn.ReLU(), nn.Identity(),
                                   nn.Linear(hidden, d_model))

    def _fold(self, y, output_size):
        return F.fold(y, output_size, self.kernel_size, stride=self.stride,
                      padding=self.padding)

    def forward(self, x, output_size):
        y = self.conv1(x).transpose(1, 2)
        counts = self._fold(torch.ones_like(y[:1]), output_size)
        img = self._fold(y, output_size) / torch.clamp(counts, min=1e-8)
        y = F.unfold(img, self.kernel_size, stride=self.stride,
                     padding=self.padding).transpose(1, 2)
        return self.conv2(y)


class Encoder(nn.Module):
    GROUPS = (2, 4, 8, 1)

    def __init__(self, in_channels: int = 4, cnum: int = 64):
        super().__init__()
        c = cnum
        spec = [(in_channels, c, 2, 1), (c, c, 1, 1), (c, 2 * c, 2, 1),
                (2 * c, 4 * c, 1, 1), (4 * c, 6 * c, 1, 1),
                (10 * c, 8 * c, 1, 2), (12 * c, 6 * c, 1, 4),
                (10 * c, 4 * c, 1, 8), (8 * c, 2 * c, 1, 1)]
        layers = []
        for cin, cout, s, g in spec:
            layers += [nn.Conv2d(cin, cout, 3, stride=s, padding=1, groups=g),
                       nn.LeakyReLU(0.2)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        convs = self.layers[::2]
        out = x
        for i in range(5):
            out = leaky_relu_02(convs[i](out))
            if i == 3:
                x0 = out
        for i, g in enumerate(self.GROUPS):
            bt, cs, h, w = x0.shape
            cy = out.shape[1]
            fused = torch.cat([x0.reshape(bt, g, cs // g, h, w),
                               out.reshape(bt, g, cy // g, h, w)], dim=2)
            out = leaky_relu_02(convs[5 + i](fused.reshape(bt, cs + cy, h, w)))
        return out


class AddPosEmb(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.proj = nn.Conv2d(channels, channels, 3, 1, 1, groups=channels)

    def forward(self, x, h, w):
        b, n, c = x.shape
        feat = x.transpose(1, 2).reshape(b, c, h, w)
        return (self.proj(feat) + feat).flatten(2).transpose(1, 2)


class Vec2Patch(nn.Module):
    def __init__(self, channels, hidden, kernel_size, stride, padding):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            tuple(kernel_size), tuple(stride), tuple(padding)
        self.embedding = nn.Linear(hidden,
                                   kernel_size[0] * kernel_size[1] * channels)

    def forward(self, x, output_size):
        return F.fold(self.embedding(x).transpose(1, 2), output_size,
                      self.kernel_size, stride=self.stride,
                      padding=self.padding)


def _cfg(cfg: dict) -> dict:
    return dict(
        in_channel=cfg.get("in_channel", 4), cnum=cfg.get("cnum", 64),
        flow_in=cfg.get("flow_inChannel", 2),
        flow_cnum=cfg.get("flow_cnum", 64),
        hidden=cfg.get("frame_hidden", 512),
        flow_hidden=cfg.get("flow_hidden", 256),
        blocks=cfg.get("numBlocks", 8),
        ks=(cfg.get("kernel_size_h", 7), cfg.get("kernel_size_w", 7)),
        stride=(cfg.get("stride_h", 3), cfg.get("stride_w", 3)),
        pad=(cfg.get("pad_h", 3), cfg.get("pad_w", 3)),
        heads=cfg.get("num_head", 4), bias=bool(cfg.get("use_bias", 1)),
        ape=bool(cfg.get("ape", 1)), mlp_ratio=cfg.get("mlp_ratio", 40),
        pass_mask=bool(cfg.get("PASSMASK", 1)), tw=cfg.get("tw", 2),
        sw=cfg.get("sw", 8), gd=cfg.get("gd", 4))


class TemporalTransformer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.attention = TMHSA(c["hidden"], c["tw"], c["heads"])
        self.norm1 = nn.LayerNorm(c["hidden"], eps=LN_EPS)
        self.norm2 = nn.LayerNorm(c["hidden"], eps=LN_EPS)
        self.ffn = FusionFeedForward(c["hidden"], c["mlp_ratio"], c["ks"],
                                     c["stride"], c["pad"])

    def forward(self, x, t, h, w, output_size):
        x = x + self.attention(self.norm1(x), t, h, w)
        return x + self.ffn(self.norm2(x), output_size)


class SpatialTransformer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.attention = FlowGuidedSWMHSA(c["hidden"], c["flow_hidden"],
                                          c["sw"], c["gd"], c["heads"])
        self.norm = nn.LayerNorm(c["hidden"], eps=LN_EPS)
        self.ffn = FusionFeedForward(c["hidden"], c["mlp_ratio"], c["ks"],
                                     c["stride"], c["pad"])

    def forward(self, x, f, h, w, output_size):
        x = x + self.attention(x, f, h, w)
        return x + self.ffn(self.norm(x), output_size)


class TransformerBlock(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.t_transformer = TemporalTransformer(c)
        self.s_transformer = SpatialTransformer(c)


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        n, kw = c["cnum"] * 2, dict(bias=c["bias"])
        self.layer1 = VanillaDeconv(n, n, 3, 1, 1, **kw)
        self.layer2 = VanillaConv(n, n // 2, 3, 1, 1, **kw)
        self.layer3 = VanillaDeconv(n // 2, n // 2, 3, 1, 1, **kw)
        self.final = VanillaConv(n // 2, 3, 3, 1, 1, activation=None, **kw)

    def forward(self, x):
        return self.final(self.layer3(self.layer2(self.layer1(x))))


class FGTNet(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        self.c = c = _cfg(config)
        self.frame_endoder = Encoder(c["in_channel"], c["cnum"])
        fc, kw = c["flow_cnum"], dict(bias=c["bias"])
        self.flow_encoder = nn.Sequential(
            nn.ReplicationPad2d(2),
            VanillaConv(c["flow_in"], fc, 5, 1, 0, **kw),
            VanillaConv(fc, 2 * fc, 3, 2, 1, **kw),
            VanillaConv(2 * fc, 2 * fc, 3, 1, 1, **kw),
            VanillaConv(2 * fc, 2 * fc, 3, 2, 1, **kw))
        self.patch2vec = nn.Conv2d(2 * c["cnum"], c["hidden"], c["ks"],
                                   c["stride"], c["pad"])
        self.f_patch2vec = nn.Conv2d(2 * fc, c["flow_hidden"], c["ks"],
                                     c["stride"], c["pad"])
        self.first_t_transformer = TemporalTransformer(c)
        self.first_s_transformer = SpatialTransformer(c)
        if c["ape"]:
            self.add_pos_emb = AddPosEmb(c["hidden"])
        self.transformer = nn.ModuleList(
            [TransformerBlock(c) for _ in range(c["blocks"] // 2 - 1)])
        self.vec2patch = Vec2Patch(2 * c["cnum"], c["hidden"], c["ks"],
                                   c["stride"], c["pad"])
        self.decoder = Decoder(c)

    def forward(self, masked_frames, flows, masks):
        c = self.c
        b, t, h, w, _ = masked_frames.shape
        dt = self.patch2vec.weight.dtype
        out_spatial = (h // 4, w // 4)
        inputs = masked_frames
        if c["pass_mask"]:
            inputs = torch.cat([masked_frames, masks], dim=-1)
        x = inputs.reshape(b * t, h, w, -1).permute(0, 3, 1, 2).to(dt)
        f = flows.reshape(b * t, h, w, -1).permute(0, 3, 1, 2).to(dt)
        enc_feats = self.frame_endoder(x)
        flow_feats = self.flow_encoder(f)
        trans = self.patch2vec(enc_feats)
        th, tw = trans.shape[2:]
        trans = trans.flatten(2).transpose(1, 2)
        flow_patch = self.f_patch2vec(flow_feats).flatten(2).transpose(1, 2)
        trans = self.first_t_transformer(trans, t, th, tw, out_spatial)
        if c["ape"]:
            trans = self.add_pos_emb(trans, th, tw)
        trans = self.first_s_transformer(trans, flow_patch, th, tw,
                                         out_spatial)
        for blk in self.transformer:
            trans = blk.t_transformer(trans, t, th, tw, out_spatial)
            trans = blk.s_transformer(trans, flow_patch, th, tw, out_spatial)
        enc_feats = enc_feats + self.vec2patch(trans, out_spatial)
        out = torch.tanh(self.decoder(enc_feats))
        return out.permute(0, 2, 3, 1).reshape(b, t, h, w, 3)


class FGT(nn.Module):
    """The port's ``Model`` wrapper: state keys under ``net.``."""

    def __init__(self, config: dict):
        super().__init__()
        self.net = FGTNet(config)

    def forward(self, frames, flows, masks):
        return self.net(frames, flows, masks)
