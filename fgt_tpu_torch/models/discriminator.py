"""Temporal PatchGAN discriminator in PyTorch — counterpart of
``fgt_tpu/models/discriminator.py`` (reference
FGT/models/temporal_patch_gan.py:7-76).

Six 3D convolutions, kernel (3, 5, 5), stride (1, 2, 2), padding
(1, 2, 2), LeakyReLU(0.2) between; spectral norm and no bias on the
first five, a plain biased conv last. Module names follow the reference
(``conv.0.weight_orig`` ... ``conv.10.weight``). The JAX module's
``use_sigmoid`` option, which no caller sets, is left out. Takes and
returns the JAX package's channel-last layout: video [B, T, H, W, C] in,
patch logits [B, T, H', W', C'] out; inside, Conv3d runs on
[B, C, T, H, W].
"""

from __future__ import annotations

import torch
import torch.nn as nn

from fgt_tpu_torch.ops.conv_blocks import (SNConv, init_kaiming,
                                           leaky_relu_02)

_K, _S, _P = (3, 5, 5), (1, 2, 2), (1, 2, 2)


class TemporalPatchGAN(nn.Module):
    def __init__(self, in_channels: int = 3, dist_cnum: int = 32):
        super().__init__()
        nf = dist_cnum
        widths = [in_channels, nf, nf * 2, nf * 4, nf * 4, nf * 4]
        layers = []
        for cin, cout in zip(widths[:-1], widths[1:]):
            layers += [SNConv(cin, cout, _K, _S, _P), nn.LeakyReLU(0.2)]
        layers.append(nn.Conv3d(nf * 4, nf * 4, _K, _S, _P))
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, sn_update: bool = False):
        """x [B, T, H, W, C] -> logits [B, T, H', W', C']; ``sn_update``
        runs one power iteration in every spectral-norm conv."""
        y = x.permute(0, 4, 1, 2, 3)
        for m in self.conv[:-1:2]:
            y = leaky_relu_02(m(y, sn_update=sn_update))
        return self.conv[-1](y).permute(0, 2, 3, 4, 1)


def init_discriminator(model: TemporalPatchGAN,
                       gen: torch.Generator) -> TemporalPatchGAN:
    """Seeded He fan-in weights, zero bias, unit random u/v (the JAX
    package's ``kaiming_fan_in`` init)."""
    init_kaiming(model, gen, mode="fan_in")
    return model
