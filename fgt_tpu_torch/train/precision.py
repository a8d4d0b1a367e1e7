"""Mixed precision of the training steps, as the JAX steps run it
(``compute_dtype`` of ``fgt_tpu/train/fgt_step.py`` and
``fgt_tpu/train/lafc_step.py``): a model's forward runs on bf16 copies
of its floating parameters, buffers and inputs, so every layer computes
in bf16, LayerNorm and softmax included; parameters, optimizer state and
the losses stay f32, and the gradients reach the f32 parameters through
the casts. Under ``torch.autocast``, which keeps LayerNorm in f32, a
LayerNorm's update left the bound the JAX package's own bf16 deviation
sets (``tests/test_torch_port_train.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn


def forward(module: nn.Module, mixed_precision: bool, *inputs, **kwargs):
    """``module(*inputs, **kwargs)``; with ``mixed_precision`` on bf16
    copies of its floating parameters, buffers and inputs (outputs come
    back in bf16: the caller casts them)."""
    if not mixed_precision:
        return module(*inputs, **kwargs)

    def bf16(t):
        return t.to(torch.bfloat16) if t.is_floating_point() else t

    state = {k: bf16(v) for k, v in (*module.named_parameters(),
                                      *module.named_buffers())}
    return torch.func.functional_call(
        module, state, tuple(bf16(a) for a in inputs), kwargs)
