"""Vanilla conv blocks (2D/3D) — the counterpart of ``fgt_tpu.ops.
conv_blocks`` restricted to what the default LAFC and FGT configs use
(``conv_type: vanilla``, no norm).

Module and attribute names follow the reference network_blocks(_2d).py
(``featureConv``; a deconv wraps its conv as ``conv``) so reference
``state_dict`` keys load as they are. Layout is torch's NC[D]HW.

Reference quirks kept: activation (leaky ReLU 0.2 by default) after the
conv; deconv = nearest x2 upsample then conv. Torch's symmetric int/tuple
padding equals the JAX package's ``resolve_padding`` pairs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

IntOrSeq = Union[int, Sequence[int]]


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _tuple(v: IntOrSeq, n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


class VanillaConv(nn.Module):
    """Conv -> activation (reference VanillaConv / VanillaConv2d with
    norm=None). ``rank`` 2 or 3 picks Conv2d / Conv3d."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 bias: bool = True, rank: int = 2,
                 activation: Optional[str] = "lrelu"):
        super().__init__()
        conv = nn.Conv2d if rank == 2 else nn.Conv3d
        self.featureConv = conv(
            in_channels, out_channels, _tuple(kernel_size, rank),
            stride=_tuple(stride, rank), padding=_tuple(padding, rank),
            dilation=_tuple(dilation, rank), bias=bias)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.featureConv(x)
        return leaky_relu_02(y) if self.activation == "lrelu" else y


class VanillaDeconv(nn.Module):
    """Nearest x2 upsample of the two trailing spatial dims, then a
    VanillaConv (reference VanillaDeconv)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, bias: bool = True):
        super().__init__()
        self.conv = VanillaConv(in_channels, out_channels, kernel_size,
                                stride, padding, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def init_kaiming(module: nn.Module, gen: torch.Generator,
                 mode: str = "fan_in") -> None:
    """Seeded He-normal conv/linear weights, zero biases (the JAX
    package's ``variance_scaling(2.0, mode, "normal")``)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            w = m.weight
            rf = w[0, 0].numel() if w.dim() > 2 else 1
            fan = (w.shape[1] if mode == "fan_in" else w.shape[0]) * rf
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=gen)
                        * (2.0 / fan) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()


def init_normal(module: nn.Module, gen: torch.Generator,
                std: float = 0.02) -> None:
    """Seeded N(0, std) conv/linear weights, zero biases, unit LayerNorm
    (the FGT generator's ``normal(0.02)`` init)."""
    for m in module.modules():
        with torch.no_grad():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
