"""FGT generator — flow-guided transformer video inpainter in PyTorch;
counterpart of ``fgt_tpu/models/fgt.py`` (reference
FGT/models/model.py:12-283).

Module names follow the reference tree (``net.frame_endoder.layers``,
``net.first_t_transformer.attention.query_embedding`` ...). Inside,
convolutions are NCHW with the (b, t) axes folded into the batch; tokens
are [B·T, N, C]. :class:`Model` takes and returns the JAX package's
``[B, T, H, W, C]`` layouts.

Multi-GPU (``parallel/partition.shard_module`` gives the generator its
mesh): tensor parallelism lives in the attention and FFN modules; with
``FGTConfig.seq_axis`` naming a mesh axis of more than one rank
(Ulysses, JAX ``FGTConfig.seq_axis``), the folded b·t frames are split
over that axis's ranks at the trunk's entry (contiguous shares, uneven
where the ranks do not divide b·t), every per-frame stage runs on this
rank's frames, TMHSA re-scatters by heads, and the output is gathered
back to every rank at the exit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fgt_tpu_torch.ops.attention import (LN_EPS, TMHSA, FlowGuidedSWMHSA,
                                         FrameShard)
from fgt_tpu_torch.ops.conv_blocks import (conv_classes, init_normal,
                                           leaky_relu_02,
                                           require_buildable)
from fgt_tpu_torch.ops.ffn import FusionFeedForward
from fgt_tpu_torch.parallel.collectives import (frame_splits, gather_frames,
                                                group_rank)


@dataclasses.dataclass
class FGTConfig:
    """Model hyperparameters (reference FGT/config/train.yaml:58-90)."""

    in_channel: int = 4
    cnum: int = 64
    flow_in_channel: int = 2
    flow_cnum: int = 64
    frame_hidden: int = 512
    flow_hidden: int = 256
    num_blocks: int = 8
    kernel_size: Tuple[int, int] = (7, 7)
    stride: Tuple[int, int] = (3, 3)
    padding: Tuple[int, int] = (3, 3)
    num_heads: int = 4
    conv_type: str = "vanilla"      # flow encoder and decoder blocks
    norm: Optional[str] = None      # their norm: BN, IN, SN or None
    use_bias: bool = True
    ape: bool = True
    mlp_ratio: int = 40
    pass_mask: bool = True
    tw: int = 2
    sw: int = 8
    gd: int = 4
    seq_axis: Optional[str] = None   # mesh axis of Ulysses frame sharding

    @classmethod
    def from_dict(cls, cfg: dict) -> "FGTConfig":
        """JAX ``FGTConfig.from_dict``'s keys and precedence: reference
        names win over their aliases (``flow_inChannel``, ``numBlocks``,
        ``num_head``, ``PASSMASK``), and a truthy pair key
        (``kernel_size``, ``stride``, ``padding``) over its ``_h`` / ``_w``
        keys; ``norm`` None, "None" or "none" (or a non-string) means no
        norm. Raises where :func:`require_buildable` does."""
        conv_type, norm = require_buildable(cfg, "FGT")
        get = cfg.get
        ks = get("kernel_size") or (get("kernel_size_h", 7),
                                    get("kernel_size_w", 7))
        st = get("stride") or (get("stride_h", 3), get("stride_w", 3))
        pd = get("padding") or (get("pad_h", 3), get("pad_w", 3))
        return cls(
            in_channel=get("in_channel", 4), cnum=get("cnum", 64),
            flow_in_channel=get("flow_inChannel", get("flow_in_channel", 2)),
            flow_cnum=get("flow_cnum", 64),
            frame_hidden=get("frame_hidden", 512),
            flow_hidden=get("flow_hidden", 256),
            num_blocks=get("numBlocks", get("num_blocks", 8)),
            kernel_size=tuple(ks), stride=tuple(st), padding=tuple(pd),
            num_heads=get("num_head", get("num_heads", 4)),
            conv_type=conv_type, norm=norm,
            use_bias=bool(get("use_bias", 1)),
            ape=bool(get("ape", 1)), mlp_ratio=get("mlp_ratio", 40),
            pass_mask=bool(get("PASSMASK", get("pass_mask", 1))),
            tw=get("tw", 2), sw=get("sw", 8), gd=get("gd", 4),
            seq_axis=get("seq_axis", None))


class Encoder(nn.Module):
    """9-conv frame encoder with grouped skip fusion (reference Encoder,
    model.py:28-66); widths as multiples of ``cnum`` like the JAX
    package (identical at cnum=64). ``layers`` alternates conv and
    LeakyReLU, so the convs sit at even indices as in the reference."""

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
    """Depthwise 3x3 conv positional encoding, residual (model.py:69-88)."""

    def __init__(self, channels: int):
        super().__init__()
        self.proj = nn.Conv2d(channels, channels, 3, 1, 1, groups=channels)

    def forward(self, x, h: int, w: int):
        b, n, c = x.shape
        feat = x.transpose(1, 2).reshape(b, c, h, w)
        return (self.proj(feat) + feat).flatten(2).transpose(1, 2)


class Vec2Patch(nn.Module):
    """Linear token -> patch embedding + fold (model.py:91-110)."""

    def __init__(self, channels: int, hidden: int, kernel_size, stride,
                 padding):
        super().__init__()
        self.kernel_size, self.stride, self.padding = \
            tuple(kernel_size), tuple(stride), tuple(padding)
        self.embedding = nn.Linear(hidden,
                                   kernel_size[0] * kernel_size[1] * channels)

    def forward(self, x, output_size):
        feat = self.embedding(x).transpose(1, 2)
        return F.fold(feat, output_size, self.kernel_size,
                      stride=self.stride, padding=self.padding)


class TemporalTransformer(nn.Module):
    """Pre-norm TMHSA + fusion FFN (model.py:113-130)."""

    def __init__(self, cfg: FGTConfig):
        super().__init__()
        self.attention = TMHSA(cfg.frame_hidden, cfg.tw, cfg.num_heads)
        self.norm1 = nn.LayerNorm(cfg.frame_hidden, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(cfg.frame_hidden, eps=LN_EPS)
        self.ffn = FusionFeedForward(cfg.frame_hidden, cfg.mlp_ratio,
                                     cfg.kernel_size, cfg.stride, cfg.padding)

    def forward(self, x, t, h, w, output_size, shard=None):
        x = x + self.attention(self.norm1(x), t, h, w, shard)
        return x + self.ffn(self.norm2(x), output_size)


class SpatialTransformer(nn.Module):
    """Flow-guided SWMHSA on the raw stream + fusion FFN
    (model.py:133-149)."""

    def __init__(self, cfg: FGTConfig):
        super().__init__()
        self.attention = FlowGuidedSWMHSA(cfg.frame_hidden, cfg.flow_hidden,
                                          cfg.sw, cfg.gd, cfg.num_heads)
        self.norm = nn.LayerNorm(cfg.frame_hidden, eps=LN_EPS)
        self.ffn = FusionFeedForward(cfg.frame_hidden, cfg.mlp_ratio,
                                     cfg.kernel_size, cfg.stride, cfg.padding)

    def forward(self, x, f, h, w, output_size):
        x = x + self.attention(x, f, h, w)
        return x + self.ffn(self.norm(x), output_size)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: FGTConfig):
        super().__init__()
        self.t_transformer = TemporalTransformer(cfg)
        self.s_transformer = SpatialTransformer(cfg)


class Decoder(nn.Module):
    """Deconv x2 / conv decoder back to RGB (model.py:176-193), in the
    config's conv_type and norm; the ``final`` conv has no activation
    and is normalised too (the tanh follows in :class:`FGT`)."""

    def __init__(self, cfg: FGTConfig):
        super().__init__()
        c = cfg.cnum * 2
        conv, deconv = conv_classes[cfg.conv_type]
        kw = dict(bias=cfg.use_bias, norm=cfg.norm)
        self.layer1 = deconv(c, c, 3, 1, 1, **kw)
        self.layer2 = conv(c, c // 2, 3, 1, 1, **kw)
        self.layer3 = deconv(c // 2, c // 2, 3, 1, 1, **kw)
        self.final = conv(c // 2, 3, 3, 1, 1, activation=None, **kw)

    def forward(self, x):
        return self.final(self.layer3(self.layer2(self.layer1(x))))


class FGT(nn.Module):
    def __init__(self, cfg: FGTConfig):
        super().__init__()
        self.cfg = c = cfg
        self.frame_endoder = Encoder(c.in_channel, c.cnum)  # reference typo
        fc = c.flow_cnum
        conv = conv_classes[c.conv_type][0]
        kw = dict(bias=c.use_bias, norm=c.norm)
        self.flow_encoder = nn.Sequential(
            nn.ReplicationPad2d(2),
            conv(c.flow_in_channel, fc, 5, 1, 0, **kw),
            conv(fc, 2 * fc, 3, 2, 1, **kw),
            conv(2 * fc, 2 * fc, 3, 1, 1, **kw),
            conv(2 * fc, 2 * fc, 3, 2, 1, **kw))
        self.patch2vec = nn.Conv2d(2 * c.cnum, c.frame_hidden, c.kernel_size,
                                   c.stride, c.padding)
        self.f_patch2vec = nn.Conv2d(2 * fc, c.flow_hidden, c.kernel_size,
                                     c.stride, c.padding)
        self.first_t_transformer = TemporalTransformer(c)
        self.first_s_transformer = SpatialTransformer(c)
        if c.ape:
            self.add_pos_emb = AddPosEmb(c.frame_hidden)
        self.transformer = nn.ModuleList(
            [TransformerBlock(c) for _ in range(c.num_blocks // 2 - 1)])
        self.vec2patch = Vec2Patch(2 * c.cnum, c.frame_hidden, c.kernel_size,
                                   c.stride, c.padding)
        self.decoder = Decoder(c)
        self.mesh = None          # set by parallel.partition.shard_module

    def _frame_shard(self, bt: int) -> Optional[FrameShard]:
        """This rank's share of the b·t frames when ``seq_axis`` names a
        mesh axis of more than one rank, else None."""
        axis = self.cfg.seq_axis
        if axis is None or self.mesh is None or self.mesh.size(axis) == 1:
            return None
        sp = self.mesh.size(axis)
        heads = self.first_t_transformer.attention.local_heads
        if heads % sp or bt < sp:
            raise ValueError(f"sequence parallelism over {sp} ranks needs "
                             f"whole heads ({heads} a tp rank) and a frame "
                             f"a rank ({bt} frames)")
        return FrameShard(frame_splits(bt, sp), self.mesh.group(axis))

    def forward(self, masked_frames, flows, masks):
        """[B, T, H, W, 3] frames in [-1, 1], [B, T, H, W, 2] flows,
        [B, T, H, W, 1] masks -> [B, T, H, W, 3] in [-1, 1]."""
        c = self.cfg
        b, t, h, w, _ = masked_frames.shape
        dt = self.patch2vec.weight.dtype
        out_spatial = (h // 4, w // 4)
        inputs = masked_frames
        if c.pass_mask:
            inputs = torch.cat([masked_frames, masks], dim=-1)
        x = inputs.reshape(b * t, h, w, -1).permute(0, 3, 1, 2).to(dt)
        f = flows.reshape(b * t, h, w, -1).permute(0, 3, 1, 2).to(dt)
        shard = self._frame_shard(b * t)
        if shard is not None:
            i = group_rank(shard.group)
            start = sum(shard.splits[:i])
            x = x[start:start + shard.splits[i]]
            f = f[start:start + shard.splits[i]]

        enc_feats = self.frame_endoder(x)
        flow_feats = self.flow_encoder(f)
        trans = self.patch2vec(enc_feats)
        th, tw = trans.shape[2:]
        trans = trans.flatten(2).transpose(1, 2)           # [bt, N, hidden]
        flow_patch = self.f_patch2vec(flow_feats).flatten(2).transpose(1, 2)

        trans = self.first_t_transformer(trans, t, th, tw, out_spatial,
                                         shard)
        if c.ape:
            trans = self.add_pos_emb(trans, th, tw)
        trans = self.first_s_transformer(trans, flow_patch, th, tw,
                                         out_spatial)
        for blk in self.transformer:
            trans = blk.t_transformer(trans, t, th, tw, out_spatial, shard)
            trans = blk.s_transformer(trans, flow_patch, th, tw, out_spatial)

        enc_feats = enc_feats + self.vec2patch(trans, out_spatial)
        out = torch.tanh(self.decoder(enc_feats))
        if shard is not None:
            out = gather_frames(out, shard.splits, shard.group)
        return out.permute(0, 2, 3, 1).reshape(b, t, h, w, 3)


class Model(nn.Module):
    """Reference-compatible wrapper: ``Model(config)(frames, flows,
    masks)`` (reference model.py:12-25)."""

    def __init__(self, config: dict):
        super().__init__()
        self.net = FGT(FGTConfig.from_dict(config))

    def forward(self, frames, flows, masks):
        return self.net(frames, flows, masks)


def init_fgt(model: Model, gen: torch.Generator) -> Model:
    """Seeded N(0, 0.02) weights (reference init_weights 'normal')."""
    init_normal(model, gen, 0.02)
    return model
