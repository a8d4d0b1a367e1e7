"""Legacy building blocks of the reference's utility layer
(FGT/models/utils/util.py:125-329 and the LAFC copy) — the counterpart
of ``fgt_tpu.ops.legacy_blocks``: ASPP, gated 2-D / 3-D convs with
optional spectral norm and their resize-deconv variants, and the
truncated-normal initialiser.

No shipped model uses them; they belong to the public block library.
Submodule names are the JAX package's (``conv`` / ``mask_conv``,
``input_conv`` / ``gating_conv``, ``conv00`` ...), so its variable
trees map one to one. Layout is NCHW (2-D) and NCDHW (3-D).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from fgt_tpu_torch.ops.conv_blocks import (IntOrSeq, apply_conv,
                                           leaky_relu_02, make_conv,
                                           upsample_nearest)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (util.py:125-144): the input is
    scaled by ``1/len(rates)``; each branch is a 3x3 conv dilated and
    padded by its rate, then LeakyReLU(0.2), giving ``out_channels //
    len(rates)`` features; the branches concatenate on the channels."""

    def __init__(self, in_channels: int, out_channels: int,
                 rates: Sequence[int] = (1, 2, 4, 8)):
        super().__init__()
        self.rates = tuple(rates)
        for i, r in enumerate(self.rates):
            setattr(self, f"conv{i:02d}", make_conv(
                in_channels, out_channels // len(self.rates), 3,
                padding=r, dilation=r))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x / len(self.rates)
        return torch.cat([leaky_relu_02(getattr(self, f"conv{i:02d}")(x))
                          for i in range(len(self.rates))], dim=1)


class GatedConv2dWithActivation(nn.Module):
    """``act(conv(x)) * sigmoid(mask_conv(x))`` (util.py:147-183; the SN
    variant at :208-243 is ``spectral_norm=True``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq = 3, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 spectral_norm: bool = False, use_activation: bool = True):
        super().__init__()
        kw = dict(kernel_size=kernel_size, stride=stride, padding=padding,
                  dilation=dilation, spectral_norm=spectral_norm)
        self.conv = make_conv(in_channels, out_channels, **kw)
        self.mask_conv = make_conv(in_channels, out_channels, **kw)
        self.use_activation = use_activation

    def forward(self, x: torch.Tensor, sn_update: bool = False):
        feat = apply_conv(self.conv, x, sn_update)
        gate = apply_conv(self.mask_conv, x, sn_update)
        if self.use_activation:
            feat = leaky_relu_02(feat)
        return feat * torch.sigmoid(gate)


class GatedDeConv2dWithActivation(nn.Module):
    """Nearest upsample, then the gated conv (util.py:186-205 / SN
    variant :245-263)."""

    def __init__(self, scale_factor: int, in_channels: int,
                 out_channels: int, kernel_size: IntOrSeq = 3,
                 stride: IntOrSeq = 1, padding: IntOrSeq = 0,
                 spectral_norm: bool = False):
        super().__init__()
        self.scale_factor = scale_factor
        self.conv2d = GatedConv2dWithActivation(
            in_channels, out_channels, kernel_size, stride, padding,
            spectral_norm=spectral_norm)

    def forward(self, x: torch.Tensor, sn_update: bool = False):
        return self.conv2d(upsample_nearest(x, self.scale_factor), sn_update)


class GatedConv3d(nn.Module):
    """``act(input_conv(x)) * sigmoid(gating_conv(x))``
    (util.py:266-281) on [B, C, T, H, W]."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq = 3, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0):
        super().__init__()
        kw = dict(kernel_size=kernel_size, stride=stride, padding=padding,
                  rank=3)
        self.input_conv = make_conv(in_channels, out_channels, **kw)
        self.gating_conv = make_conv(in_channels, out_channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu_02(self.input_conv(x)) * torch.sigmoid(
            self.gating_conv(x))


class GatedDeconv3d(nn.Module):
    """Spatial-only nearest upsample (the temporal axis is never
    scaled), then the 3-D gated conv (util.py:284-294)."""

    def __init__(self, scale_factor: int, in_channels: int,
                 out_channels: int, kernel_size: IntOrSeq = 3,
                 stride: IntOrSeq = 1, padding: IntOrSeq = 0):
        super().__init__()
        self.scale_factor = scale_factor
        self.deconv = GatedConv3d(in_channels, out_channels, kernel_size,
                                  stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(upsample_nearest(x, self.scale_factor))


def trunc_normal_init(std: float = 1.0, mean: float = 0.0, a: float = -2.0,
                      b: float = 2.0):
    """Truncated-normal initialiser matching ``trunc_normal_``
    (util.py:297-329): ``init(shape, generator=None)`` samples N(mean,
    std) restricted to [a, b]."""

    def init(shape, generator=None, dtype=torch.float32):
        t = torch.empty(shape, dtype=dtype)
        return nn.init.trunc_normal_(t, mean, std, a, b, generator=generator)

    return init
