"""Vanilla conv blocks (2D/3D) and the spectral-norm 3D conv — the
counterpart of ``fgt_tpu.ops.conv_blocks`` restricted to what the default
LAFC, FGT and T-PatchGAN configs use (``conv_type: vanilla``, no norm).

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


def require_vanilla(cfg: dict, model: str) -> None:
    """Refuse a config these blocks cannot build: a ``conv_type`` other
    than vanilla (the JAX package's gated and partial convolutions), or a
    ``norm`` that names a normalisation layer (any string but None /
    none, such as BN, IN or SN). A non-string ``norm`` (None, or the
    training CLI's integer data flag) names none."""
    conv_type = cfg.get("conv_type", "vanilla")
    if str(conv_type) != "vanilla":
        raise ValueError(f"{model}: conv_type={conv_type!r} is not ported "
                         "(only 'vanilla')")
    norm = cfg.get("norm")
    if isinstance(norm, str) and norm not in ("None", "none"):
        raise ValueError(f"{model}: norm={norm!r} is not ported (only "
                         "None)")


class FrozenBatchNorm(nn.Module):
    """Inference batch norm on running statistics over dim 1 of an
    N C [D] H W tensor; ``state_dict`` keys are the reference's
    weight/bias/running_mean/running_var (no ``num_batches_tracked``)."""

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


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + 1e-12)


class SNConv3d(nn.Module):
    """Conv3d with spectral normalization (``ConvND(spectral_norm=True)``
    of the JAX package, ``conv_blocks.py:55-137``).

    State names are those of ``torch.nn.utils.spectral_norm``:
    ``weight_orig`` (OIDHW parameter) and the ``weight_u`` [O] /
    ``weight_v`` [I·D·H·W] power-iteration buffers, so a reference state
    dict loads as it is. Unlike torch's hook, which iterates on every
    training-mode forward, the power iteration runs only when the caller
    passes ``sn_update=True`` (one step, eps 1e-12), as the JAX package's
    discriminator calls do; the G step applies D without it. The new u, v
    replace the buffers rather than overwrite them, so a graph that saved
    the old ones stays valid. The weight is divided by
    sigma = u·W·v with u and v detached."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0):
        super().__init__()
        k = _tuple(kernel_size, 3)
        self.stride, self.padding = _tuple(stride, 3), _tuple(padding, 3)
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels, *k))
        rest = in_channels * k[0] * k[1] * k[2]
        self.register_buffer("weight_u", torch.zeros(out_channels))
        self.register_buffer("weight_v", torch.zeros(rest))

    def forward(self, x: torch.Tensor, sn_update: bool = False):
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if sn_update:
            with torch.no_grad():
                v = _normalize(mat.t() @ u)
                u = _normalize(mat @ v)
            self.weight_u, self.weight_v = u, v
        sigma = torch.dot(u, mat @ v)
        return F.conv3d(x, w / sigma, None, self.stride, self.padding)


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
    """Seeded He-normal conv/linear weights, zero biases, unit random
    spectral-norm u/v (the JAX package's ``variance_scaling(2.0, mode,
    "normal")``)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, SNConv3d)):
            w = m.weight_orig if isinstance(m, SNConv3d) else m.weight
            rf = w[0, 0].numel() if w.dim() > 2 else 1
            fan = (w.shape[1] if mode == "fan_in" else w.shape[0]) * rf
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=gen)
                        * (2.0 / fan) ** 0.5)
                if isinstance(m, SNConv3d):   # no bias; unit u, v
                    m.weight_u.copy_(_normalize(torch.randn(
                        m.weight_u.shape, generator=gen)))
                    m.weight_v.copy_(_normalize(torch.randn(
                        m.weight_v.shape, generator=gen)))
                elif m.bias is not None:
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
