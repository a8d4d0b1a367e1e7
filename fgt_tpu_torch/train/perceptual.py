"""VGG19 perceptual and style (gram) losses — counterpart of
``fgt_tpu/train/perceptual.py`` (reference LAFC/models/utils/
flow_losses.py:128-310, FGT/models/utils/loss.py:143-213). Defined and
available but not in the default loss mix, here as in the reference.

:class:`VGG19Features` keeps torchvision's ``features.<idx>`` layer
indices, so the ``features.*`` entries of a torchvision ``vgg19``
state dict load as they are; ``convert.weights.vgg19_mapping`` carries
the JAX package's ``conv0 .. conv15`` across. Taps: relu1_1 .. relu5_1.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision vgg19.features: (convs, width) per block, a 2x2 max pool
# between blocks
_CFG = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]
# reference taps relu1_1 .. relu5_1 with weights 1/32, 1/16, 1/8, 1/4, 1
TAP_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def conv_indices() -> list:
    """The ``features.<idx>`` index of each of the 16 convolutions."""
    out, idx = [], 0
    for n_convs, _ in _CFG:
        for _ in range(n_convs):
            out.append(idx)
            idx += 2                           # conv, relu
        idx += 1                               # max pool
    return out


class VGG19Features(nn.Module):
    """NHWC image in [0, 1] -> the [relu1_1 .. relu5_1] feature maps,
    NHWC (ImageNet-normalized inside, as the reference)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for n_convs, width in _CFG:
            for _ in range(n_convs):
                layers += [nn.Conv2d(cin, width, 3, padding=1),
                           nn.ReLU(inplace=False)]
                cin = width
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_STD).view(1, 3, 1, 1),
                             persistent=False)
        convs = conv_indices()
        # relu after the first conv of each block
        self._taps = {convs[i] + 1 for i in (0, 2, 4, 8, 12)}

    def forward(self, x: torch.Tensor) -> list:
        x = (x.permute(0, 3, 1, 2) - self.mean) / self.std
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                taps.append(x.permute(0, 2, 3, 1))
                if len(taps) == len(self._taps):
                    break
        return taps


def _gram(feat: torch.Tensor) -> torch.Tensor:
    b, h, w, c = feat.shape
    f = feat.reshape(b, h * w, c)
    return torch.einsum("bnc,bnd->bcd", f, f) / (h * w * c)


def perceptual_loss(vgg: VGG19Features, pred: torch.Tensor,
                    target: torch.Tensor,
                    weights: Sequence[float] = TAP_WEIGHTS) -> torch.Tensor:
    """Weighted feature L1 (reference loss.py:178-189); NHWC in [0, 1],
    no gradient into ``target``."""
    fp = vgg(pred)
    with torch.no_grad():
        ft = vgg(target)
    total = 0.0
    for w, a, b in zip(weights, fp, ft):
        total = total + w * F.l1_loss(a, b)
    return total


def style_loss(vgg: VGG19Features, pred: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """Gram-matrix L1 over the same taps (reference loss.py:191-213)."""
    fp = vgg(pred)
    with torch.no_grad():
        ft = vgg(target)
    total = 0.0
    for a, b in zip(fp, ft):
        total = total + F.l1_loss(_gram(a), _gram(b))
    return total
