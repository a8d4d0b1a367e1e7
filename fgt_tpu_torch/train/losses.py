"""Training losses of the FGT GAN step — counterpart of
``fgt_tpu/train/losses.py:27-50``:

* masked/valid mean-normalized L1 (reference FGT/networks/network.py:146-151);
* adversarial hinge / nsgan / lsgan (reference
  LAFC/models/utils/flow_losses.py:88-125).

The flow and edge losses serve LAFC training, which is not ported yet.
"""

from __future__ import annotations

import torch


def l1_normalized(pred: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """``L1(pred*m, target*m) / mean(m)``."""
    return torch.mean(torch.abs(pred * mask - target * mask)) / torch.clamp(
        torch.mean(mask), min=1e-8)


def adversarial_loss(outputs: torch.Tensor, is_real: bool, is_disc: bool,
                     kind: str = "hinge") -> torch.Tensor:
    if kind == "hinge":
        if is_disc:
            sign = -1.0 if is_real else 1.0
            return torch.mean(torch.relu(1.0 + sign * outputs))
        return torch.mean(-outputs)
    target = torch.ones_like(outputs) if is_real else torch.zeros_like(outputs)
    if kind == "nsgan":
        p = torch.clamp(outputs, 1e-7, 1 - 1e-7)
        return torch.mean(-(target * torch.log(p)
                            + (1 - target) * torch.log(1 - p)))
    if kind == "lsgan":
        return torch.mean((outputs - target) ** 2)
    raise ValueError(kind)
