"""FGT fusion feed-forward block on torch's native fold/unfold —
counterpart of ``fgt_tpu/ops/ffn.py`` (reference ffn_base.py:33-77).

Tokens [B, N, d_model] go up to ``kh·kw·mlp_ratio`` channels, are folded
into the (H/4, W/4) patch space with overlap averaging, unfolded back,
and projected down. Patch features are channel-major (torch's
``F.unfold`` order), the order the JAX package reproduces.

Under tensor parallelism (:meth:`FusionFeedForward.shard`) a rank holds
hidden / tp of the channels — whole fold channels, hidden being a
multiple of k·k per rank — with ``conv1`` column-parallel behind
Megatron's *f* and ``conv2.2`` row-parallel, all-reduced before its
replicated bias. The overlap counts do not depend on the channels.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fgt_tpu_torch.parallel.collectives import (copy_to_group,
                                                row_parallel_linear)


class FusionFeedForward(nn.Module):
    def __init__(self, d_model: int, mlp_ratio: int,
                 kernel_size: Sequence[int], stride: Sequence[int],
                 padding: Sequence[int]):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        hidden = self.kernel_size[0] * self.kernel_size[1] * mlp_ratio
        self.conv1 = nn.Linear(d_model, hidden)
        # reference nn.Sequential(ReLU, Dropout, Linear): keys conv2.2.*
        self.conv2 = nn.Sequential(nn.ReLU(), nn.Identity(),
                                   nn.Linear(hidden, d_model))
        self.tp_group = None

    def shard(self, group, tp: int) -> None:
        """Run on this rank's hidden / tp channels, collectives on
        ``group`` (``parallel/partition.shard_module`` slices the
        weights)."""
        kk = self.kernel_size[0] * self.kernel_size[1]
        local = self.conv1.out_features // tp
        if local % kk:
            raise ValueError(f"FusionFeedForward: {local} hidden channels "
                             f"a rank are not whole fold channels of {kk}")
        self.tp_group = group

    def _fold(self, y: torch.Tensor, output_size) -> torch.Tensor:
        return F.fold(y, output_size, self.kernel_size, stride=self.stride,
                      padding=self.padding)

    def forward(self, x: torch.Tensor, output_size: tuple) -> torch.Tensor:
        """x: [B, N, d_model]; output_size: patch-space (H/4, W/4)."""
        x = copy_to_group(x, self.tp_group)
        y = self.conv1(x).transpose(1, 2)                 # [B, hidden, N]
        counts = self._fold(torch.ones_like(y[:1]), output_size)
        img = self._fold(y, output_size) / torch.clamp(counts, min=1e-8)
        y = F.unfold(img, self.kernel_size, stride=self.stride,
                     padding=self.padding).transpose(1, 2)
        return row_parallel_linear(self.conv2[2], self.conv2[0](y),
                                   self.tp_group)
