"""Reconstruction layers (reference
FGT/models/utils/reconstructionLayers.py) — the counterpart of
``fgt_tpu.ops.recon_layers``.

The shipped models use only ``ResidualBlockNoBN`` (LAFC-single's,
re-exported here); ``ResBlockNoBNNew`` and ``CCALayer`` complete the
published block library. Submodule names are the JAX package's. Layout
is NCHW (2-D) and NCTHW (the 3-D block).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from fgt_tpu_torch.models.lafc_single import ResidualBlockNoBN  # noqa: F401
from fgt_tpu_torch.ops.conv_blocks import leaky_relu_02


def make_layer(block_fn: Callable[[int], nn.Module],
               n_layers: int) -> nn.Sequential:
    """Sequential stack (reconstructionLayers.py:27-31); ``block_fn(i)``
    builds the i-th block."""
    return nn.Sequential(*[block_fn(i) for i in range(n_layers)])


def mean_channels(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) spatial mean of NCHW, kept as [B, C, 1, 1]
    (:131-134)."""
    assert x.dim() == 4, f"want NCHW, got {tuple(x.shape)}"
    return x.mean(dim=(2, 3), keepdim=True)


def stdv_channels(x: torch.Tensor) -> torch.Tensor:
    """Per-(batch, channel) spatial std, biased (:137-141)."""
    m = mean_channels(x)
    return ((x - m) ** 2).mean(dim=(2, 3), keepdim=True).sqrt()


class ResBlockNoBNNew(nn.Module):
    """Multi-dilation (1/2/4/8) spatial residual block over
    [B, C, T, H, W] (:64-95): (1, 3, 3) convs, progressive-sum concat,
    LeakyReLU."""

    def __init__(self, features: int):
        super().__init__()
        nf4 = features // 4

        def conv(cin, cout, d=1):
            return nn.Conv3d(cin, cout, (1, 3, 3), padding=(0, d, d),
                             dilation=(1, d, d))

        self.c1 = conv(features, nf4)
        self.d1, self.d2 = conv(nf4, nf4), conv(nf4, nf4, 2)
        self.d3, self.d4 = conv(nf4, nf4, 4), conv(nf4, nf4, 8)
        self.c2 = conv(4 * nf4, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = leaky_relu_02(self.c1(x))
        d1, d2, d3, d4 = self.d1(y), self.d2(y), self.d3(y), self.d4(y)
        add1 = d1 + d2
        add2 = add1 + d3
        add3 = add2 + d4
        combine = torch.cat([d1, add1, add2, add3], dim=1)
        return x + self.c2(leaky_relu_02(combine))


class CCALayer(nn.Module):
    """Contrast-channel-attention residual block (:98-128):
    conv-lrelu-conv, then a per-channel gate from contrast (std) + mean
    through a 1x1 bottleneck with tanh."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.du1 = nn.Conv2d(features, 4, 1)
        self.du2 = nn.Conv2d(4, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(leaky_relu_02(self.conv1(x)))
        stat = stdv_channels(y) + mean_channels(y)
        g = torch.tanh(self.du2(torch.relu(self.du1(stat))))
        return g * stat + x
