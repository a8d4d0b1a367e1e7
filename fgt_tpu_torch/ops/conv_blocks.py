"""Conv block library, 2D and 3D: vanilla, gated and partial
convolutions with the conv norms (BN, IN, SN) — the counterpart of
``fgt_tpu.ops.conv_blocks``.

Module and attribute names follow the reference network_blocks(_2d).py
(``featureConv``, ``gatingConv``, ``norm_layer``; a deconv wraps its
conv as ``conv``; spectral norm's ``weight_orig`` / ``weight_u`` /
``weight_v``) so reference ``state_dict`` keys load as they are. Layout
is torch's NC[D]HW.

Semantics of the JAX package kept:

* the activation (leaky ReLU 0.2 by default) comes BEFORE the norm;
* deconv = nearest x2 upsample of the two trailing spatial dims, then
  the conv (a 5-D input keeps its temporal size);
* ``padding=-1`` means "same": ``(k - 1) * dilation // 2``;
* BN is flax's ``BatchNorm`` (momentum 0.99, eps 1e-5; ``train`` uses
  the batch statistics and moves the running ones by the biased batch
  variance, else the running statistics are used);
* IN is flax's ``GroupNorm(group_size=1)``: eps 1e-6, statistics in
  f32, a learned scale and bias, no running statistics (not
  ``nn.InstanceNorm2d``);
* SN divides the weight by sigma = u·W·v, u and v detached, with one
  power-iteration step (eps 1e-12) only when the caller passes
  ``sn_update=True``;
* the partial conv renormalises by the (detached) mask sum and emits 0
  where a window saw no valid pixel.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

IntOrSeq = Union[int, Sequence[int]]
NORMS = ("BN", "IN", "SN")


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _act(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    return leaky_relu_02(x) if activation == "lrelu" else x


def _tuple(v: IntOrSeq, n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


def resolve_padding(kernel_size: IntOrSeq, dilation: IntOrSeq,
                    padding: IntOrSeq, rank: int) -> tuple:
    """Torch's symmetric padding per spatial dim; -1 means "same"."""
    k, d = _tuple(kernel_size, rank), _tuple(dilation, rank)
    if padding == -1:
        return tuple((k[i] - 1) * d[i] // 2 for i in range(rank))
    return _tuple(padding, rank)


def require_buildable(cfg: dict, model: str) -> tuple:
    """``(conv_type, norm)`` of a model config, as the JAX package's
    models build them; ``norm`` is BN, IN, SN or None (None, "None",
    "none", or a non-string such as the training CLI's integer data
    flag). Raises ValueError on ``conv_type: partial`` (the models pass
    one tensor where the partial blocks take an (x, mask) pair, so the
    JAX package's models fail to build it too), on an unknown
    ``conv_type`` and on a ``norm`` string outside None / none / BN / IN
    / SN."""
    conv_type = str(cfg.get("conv_type", "vanilla"))
    if conv_type == "partial":
        raise ValueError(
            f"{model}: conv_type='partial' does not build: its blocks take "
            "an (x, mask) pair where the model passes one tensor, and the "
            "JAX package's models cannot build it either")
    if conv_type not in conv_classes:
        raise ValueError(f"{model}: unknown conv_type={conv_type!r} (one "
                         "of 'vanilla', 'gated')")
    norm = cfg.get("norm")
    if not isinstance(norm, str) or norm in ("None", "none"):
        return conv_type, None
    if norm not in NORMS:
        raise ValueError(f"{model}: unknown norm={norm!r} (None, BN, IN "
                         "or SN)")
    return conv_type, norm


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


def _normalize(x, mean, var, weight, bias, eps, shape):
    """flax ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) +
    bias, in the dtype of x and the parameters."""
    y = (x - mean) * (torch.rsqrt(var + eps) * weight.view(shape)) \
        + bias.view(shape)
    return y.to(functools.reduce(torch.promote_types,
                                 (x.dtype, weight.dtype, bias.dtype)))


def _fast_stats(x: torch.Tensor, dims) -> tuple:
    """flax ``_compute_stats``: f32 mean and E[x²] - E[x]², clipped at
    0."""
    x = x.float()
    mean = x.mean(dims, keepdim=True)
    var = ((x * x).mean(dims, keepdim=True) - mean * mean).clamp_min(0.0)
    return mean, var


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over dim 1. The running statistics are
    Parameters, not buffers: the JAX GAN step hands the generator's whole
    variable tree, ``batch_stats`` included, to Adam and applies it with
    the running statistics (``fgt_tpu/train/trainer.py``), so they take
    gradients, casts, the data-parallel average and checkpoints as the
    weights do. ``train=True`` normalises with the batch statistics and
    moves the running ones in place."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor, train: bool = False):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            mean, var = _fast_stats(x, [0] + list(range(2, x.dim())))
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.view(-1))
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.view(-1))
        else:
            mean = self.running_mean.view(shape)
            var = self.running_var.view(shape)
        return _normalize(x, mean, var, self.weight, self.bias, self.eps,
                          shape)


class InstanceNorm(nn.Module):
    """flax ``GroupNorm(num_groups=None, group_size=1)`` over dim 1:
    per-sample, per-channel f32 statistics over the spatial dims, a
    learned scale and bias, eps 1e-6, no running statistics."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool = False):
        mean, var = _fast_stats(x, list(range(2, x.dim())))
        return _normalize(x, mean, var, self.weight, self.bias, self.eps,
                          (1, -1) + (1,) * (x.dim() - 2))


def make_norm(norm: Optional[str], channels: int) -> Optional[nn.Module]:
    """The norm layer after a block's activation (``_NormAct``): BN or
    IN; None for SN (it lives in the convs) and for no norm."""
    if norm == "BN":
        return BatchNorm(channels)
    if norm == "IN":
        return InstanceNorm(channels)
    return None


def _normalize_vec(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + 1e-12)


class SNConv(nn.Module):
    """2-D or 3-D conv with spectral normalization
    (``ConvND(spectral_norm=True)`` of the JAX package).

    State names are those of ``torch.nn.utils.spectral_norm``:
    ``weight_orig`` (O I/g k.. parameter), ``bias`` and the ``weight_u``
    [O] / ``weight_v`` [I/g·prod(k)] power-iteration buffers. Unlike
    torch's hook, which iterates on every training-mode forward, the
    power iteration runs only when the caller passes ``sn_update=True``
    (one step, eps 1e-12), as the JAX package's discriminator calls do;
    the generators never pass it. The new u, v replace the buffers
    rather than overwrite them, so a graph that saved the old ones stays
    valid. The weight is divided by sigma = u·W·v with u and v
    detached."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = False, rank: int = 3):
        super().__init__()
        k = _tuple(kernel_size, rank)
        self.rank, self.groups = rank, groups
        self.stride, self.dilation = _tuple(stride, rank), _tuple(dilation,
                                                                  rank)
        self.padding = _tuple(padding, rank)
        self.weight_orig = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *k))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter("bias", None)
        rest = self.weight_orig[0].numel()
        self.register_buffer("weight_u", torch.zeros(out_channels))
        self.register_buffer("weight_v", torch.zeros(rest))

    def forward(self, x: torch.Tensor, sn_update: bool = False):
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1)
        u, v = self.weight_u, self.weight_v
        if sn_update:
            with torch.no_grad():
                v = _normalize_vec(mat.t() @ u)
                u = _normalize_vec(mat @ v)
            self.weight_u, self.weight_v = u, v
        sigma = torch.dot(u, mat @ v)
        conv = F.conv2d if self.rank == 2 else F.conv3d
        return conv(x, w / sigma, self.bias, self.stride, self.padding,
                    self.dilation, self.groups)


def make_conv(in_channels: int, out_channels: int, kernel_size: IntOrSeq,
              stride: IntOrSeq = 1, padding: IntOrSeq = 0,
              dilation: IntOrSeq = 1, groups: int = 1, bias: bool = True,
              rank: int = 2, spectral_norm: bool = False) -> nn.Module:
    """The JAX package's rank-generic ``ConvND``: ``nn.Conv2d`` /
    ``nn.Conv3d``, or :class:`SNConv` with ``spectral_norm``."""
    k = _tuple(kernel_size, rank)
    pad = resolve_padding(k, dilation, padding, rank)
    if spectral_norm:
        return SNConv(in_channels, out_channels, k, stride, pad, dilation,
                      groups, bias, rank)
    conv = nn.Conv2d if rank == 2 else nn.Conv3d
    return conv(in_channels, out_channels, k, stride=_tuple(stride, rank),
                padding=pad, dilation=_tuple(dilation, rank),
                groups=groups, bias=bias)


def apply_conv(conv: nn.Module, x: torch.Tensor,
               sn_update: bool = False) -> torch.Tensor:
    return conv(x, sn_update=sn_update) if isinstance(conv, SNConv) \
        else conv(x)


class VanillaConv(nn.Module):
    """Conv -> activation -> norm (reference VanillaConv /
    VanillaConv2d). ``rank`` 2 or 3 picks a 2-D or 3-D conv; ``norm``
    BN / IN adds ``norm_layer``, SN makes ``featureConv`` an
    :class:`SNConv`."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 norm: Optional[str] = None,
                 activation: Optional[str] = "lrelu", rank: int = 2):
        super().__init__()
        self.featureConv = make_conv(in_channels, out_channels, kernel_size,
                                     stride, padding, dilation, groups, bias,
                                     rank, norm == "SN")
        self.norm_layer = make_norm(norm, out_channels)
        self.activation = activation

    def _norm(self, y: torch.Tensor, train: bool) -> torch.Tensor:
        return y if self.norm_layer is None else self.norm_layer(y, train)

    def forward(self, x: torch.Tensor, train: bool = False,
                sn_update: bool = False) -> torch.Tensor:
        y = _act(apply_conv(self.featureConv, x, sn_update), self.activation)
        return self._norm(y, train)


class GatedConv(VanillaConv):
    """``sigmoid(gatingConv(x)) * act(featureConv(x))``, then BN or IN;
    SN applies to both convs."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 norm: Optional[str] = None,
                 activation: Optional[str] = "lrelu", rank: int = 2):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, bias, norm, activation,
                         rank)
        self.gatingConv = make_conv(in_channels, out_channels, kernel_size,
                                    stride, padding, dilation, groups, bias,
                                    rank, norm == "SN")

    def forward(self, x: torch.Tensor, train: bool = False,
                sn_update: bool = False) -> torch.Tensor:
        feat = _act(apply_conv(self.featureConv, x, sn_update),
                    self.activation)
        gate = apply_conv(self.gatingConv, x, sn_update)
        return self._norm(torch.sigmoid(gate) * feat, train)


class PartialConv(nn.Module):
    """Mask-renormalised conv; takes and returns ``(x, mask)``
    (reference network_blocks_2d.py:113-168): ``y = W(m·x) / sum(m) + b``
    where windows with ``sum(m) == 0`` emit 0, and the new mask marks the
    windows that saw a valid pixel. The conv is bias-free (``bias`` is
    the block's own) and never spectral-normalised; BN / IN follow the
    activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 norm: Optional[str] = None,
                 activation: Optional[str] = "lrelu", rank: int = 2):
        super().__init__()
        self.rank = rank
        self.kernel_size = _tuple(kernel_size, rank)
        self.stride, self.dilation = _tuple(stride, rank), _tuple(dilation,
                                                                  rank)
        self.padding = resolve_padding(self.kernel_size, dilation, padding,
                                       rank)
        self.featureConv = make_conv(in_channels, out_channels, kernel_size,
                                     stride, padding, dilation, groups,
                                     False, rank)
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter("bias", None)
        self.norm_layer = make_norm(None if norm == "SN" else norm,
                                    out_channels)
        self.activation = activation

    def forward(self, inputs, train: bool = False, sn_update: bool = False):
        x, mask = inputs
        y = self.featureConv(mask * x)
        ones = torch.ones((1, 1) + self.kernel_size, dtype=mask.dtype,
                          device=mask.device)
        conv = F.conv2d if self.rank == 2 else F.conv3d
        mask_sum = conv(mask.detach(), ones, None, self.stride, self.padding,
                        self.dilation)
        holes = mask_sum == 0
        y = y / torch.where(holes, torch.ones_like(mask_sum), mask_sum)
        if self.bias is not None:
            y = y + self.bias.view((1, -1) + (1,) * self.rank)
        y = torch.where(holes, torch.zeros_like(y), y)
        y = _act(y, self.activation)
        if self.norm_layer is not None:
            y = self.norm_layer(y, train)
        return y, (~holes).to(mask.dtype)


def upsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of the two trailing spatial dims of
    an NCHW or NCDHW tensor; a 5-D tensor keeps its temporal size."""
    if factor == 1:
        return x
    if x.dim() not in (4, 5):
        raise ValueError(f"unsupported rank {x.dim()}")
    return F.interpolate(x, scale_factor=(1,) * (x.dim() - 4)
                         + (factor, factor), mode="nearest")


def replication_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge replication of the two trailing dims, H and W, of an NCHW or
    NCDHW tensor (reference ReplicationPad2d(p) /
    ReplicationPad3d((p, p, p, p, 0, 0)))."""
    return F.pad(x, (pad,) * 4 + (0, 0) * (x.dim() - 4), mode="replicate")


class VanillaDeconv(nn.Module):
    """Nearest x``scale_factor`` upsample, then the block ``conv``
    (reference VanillaDeconv)."""

    block = VanillaConv

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrSeq, stride: IntOrSeq = 1,
                 padding: IntOrSeq = 0, dilation: IntOrSeq = 1,
                 groups: int = 1, bias: bool = True,
                 norm: Optional[str] = None,
                 activation: Optional[str] = "lrelu", rank: int = 2,
                 scale_factor: int = 2):
        super().__init__()
        self.conv = self.block(in_channels, out_channels, kernel_size,
                               stride, padding, dilation, groups, bias, norm,
                               activation, rank)
        self.scale_factor = scale_factor

    def forward(self, x, train: bool = False, sn_update: bool = False):
        return self.conv(upsample_nearest(x, self.scale_factor),
                         train=train, sn_update=sn_update)


class GatedDeconv(VanillaDeconv):
    block = GatedConv


class PartialDeconv(VanillaDeconv):
    """Upsamples x and the (detached) mask, then the partial conv."""

    block = PartialConv

    def forward(self, inputs, train: bool = False, sn_update: bool = False):
        x, mask = inputs
        f = self.scale_factor
        return self.conv((upsample_nearest(x, f),
                          upsample_nearest(mask, f).detach()),
                         train=train, sn_update=sn_update)


conv_classes = {
    "vanilla": (VanillaConv, VanillaDeconv),
    "gated": (GatedConv, GatedDeconv),
    "partial": (PartialConv, PartialDeconv),
}


def _init_weights(module: nn.Module, gen: torch.Generator, std) -> None:
    """Seeded conv / linear weights N(0, ``std(weight)``), zero biases,
    unit random spectral-norm u / v, norm scales 1 and biases 0, BN
    running statistics 0 and 1."""
    for m in module.modules():
        with torch.no_grad():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear, SNConv)):
                w = m.weight_orig if isinstance(m, SNConv) else m.weight
                w.copy_(torch.randn(w.shape, generator=gen) * std(w))
                if isinstance(m, SNConv):
                    m.weight_u.copy_(_normalize_vec(torch.randn(
                        m.weight_u.shape, generator=gen)))
                    m.weight_v.copy_(_normalize_vec(torch.randn(
                        m.weight_v.shape, generator=gen)))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, BatchNorm, InstanceNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
            elif isinstance(m, PartialConv) and m.bias is not None:
                m.bias.zero_()


def init_kaiming(module: nn.Module, gen: torch.Generator,
                 mode: str = "fan_in") -> None:
    """Seeded He-normal conv/linear weights (the JAX package's
    ``variance_scaling(2.0, mode, "normal")``); see
    :func:`_init_weights` for the rest."""
    def std(w):
        rf = w[0, 0].numel() if w.dim() > 2 else 1
        return (2.0 / ((w.shape[1] if mode == "fan_in" else w.shape[0])
                       * rf)) ** 0.5

    _init_weights(module, gen, std)


def init_normal(module: nn.Module, gen: torch.Generator,
                std: float = 0.02) -> None:
    """Seeded N(0, std) conv/linear weights (the FGT generator's
    ``normal(0.02)`` init); see :func:`_init_weights` for the rest."""
    _init_weights(module, gen, lambda w: std)
