"""Conv blocks of the plain reference: the vanilla subset of
``fgt_tpu_torch/ops/conv_blocks.py`` at commit ac5eac9 (``VanillaConv``,
``VanillaDeconv``, ``SNConv``, ``FrozenBatchNorm``), copied with the
gated, partial, BN and IN blocks left out. Module and parameter names
are the port's, so one state dict loads into both.
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


def resolve_padding(kernel_size, dilation, padding, rank: int) -> tuple:
    k, d = _tuple(kernel_size, rank), _tuple(dilation, rank)
    if padding == -1:
        return tuple((k[i] - 1) * d[i] // 2 for i in range(rank))
    return _tuple(padding, rank)


class FrozenBatchNorm(nn.Module):
    """Batch norm on running statistics over dim 1."""

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
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.view(shape) + shift.view(shape)


def normalize_vec(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + 1e-12)


class SNConv(nn.Module):
    """Conv with spectral normalization: the weight divided by
    sigma = u·W·v (u, v detached), one power iteration only when the
    caller passes ``sn_update=True``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = False, rank: int = 3):
        super().__init__()
        k = _tuple(kernel_size, rank)
        self.rank, self.groups = rank, groups
        self.stride = _tuple(stride, rank)
        self.dilation = _tuple(dilation, rank)
        self.padding = _tuple(padding, rank)
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *k))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter("bias", None)
        self.register_buffer("weight_u", torch.zeros(out_channels))
        self.register_buffer("weight_v",
                             torch.zeros(self.weight_orig[0].numel()))

    def forward(self, x: torch.Tensor, sn_update: bool = False):
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if sn_update:
            with torch.no_grad():
                v = normalize_vec(mat.t() @ u)
                u = normalize_vec(mat @ v)
            self.weight_u, self.weight_v = u, v
        sigma = torch.dot(u, mat @ v)
        conv = F.conv2d if self.rank == 2 else F.conv3d
        return conv(x, w / sigma, self.bias, self.stride, self.padding,
                    self.dilation, self.groups)


def make_conv(cin: int, cout: int, kernel_size, stride=1, padding=0,
              dilation=1, groups: int = 1, bias: bool = True,
              rank: int = 2) -> nn.Module:
    k = _tuple(kernel_size, rank)
    pad = resolve_padding(k, dilation, padding, rank)
    conv = nn.Conv2d if rank == 2 else nn.Conv3d
    return conv(cin, cout, k, stride=_tuple(stride, rank), padding=pad,
                dilation=_tuple(dilation, rank), groups=groups, bias=bias)


class VanillaConv(nn.Module):
    """Conv -> leaky ReLU 0.2 (or none); no norm."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 norm: Optional[str] = None,
                 activation: Optional[str] = "lrelu", rank: int = 2):
        super().__init__()
        if norm is not None:
            raise ValueError("the reference holds vanilla blocks only")
        self.featureConv = make_conv(in_channels, out_channels, kernel_size,
                                     stride, padding, dilation, groups, bias,
                                     rank)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.featureConv(x)
        return leaky_relu_02(y) if self.activation == "lrelu" else y


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest upsampling of the two trailing spatial dims."""
    return F.interpolate(x, scale_factor=(1,) * (x.dim() - 4)
                         + (factor, factor), mode="nearest")


class VanillaDeconv(nn.Module):
    """Nearest x2 upsample, then the conv block (kept as ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 norm: Optional[str] = None,
                 activation: Optional[str] = "lrelu", rank: int = 2):
        super().__init__()
        self.conv = VanillaConv(in_channels, out_channels, kernel_size,
                                stride, padding, dilation, groups, bias,
                                norm, activation, rank)

    def forward(self, x):
        return self.conv(upsample_nearest(x, 2))


def replication_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad,) * 4 + (0, 0) * (x.dim() - 4), mode="replicate")


class Pad(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return replication_pad(x, self.pad)
