"""Learning-rate schedules and Adam — counterpart of
``fgt_tpu/train/schedules.py``.

StepLR with gamma ``lr_decay`` every ``UPDATE_INTERVAL`` steps
(reference FGT/networks/network.py:36-40) plus the warmup rule of
``_trainEpoch`` (network.py:94-98) with its quirk: the warmup WINDOW is
``WARMUP // world_size`` steps but the SLOPE divides by the full
``WARMUP``, so with world_size > 1 warmup ends below the target lr and
jumps.

A schedule is a plain function of the step, counted from 0 as optax's
count is. :func:`set_lr` writes ``schedule(step)`` into an optimizer
before its update. Adam is ``torch.optim.Adam(betas, eps=1e-8)``, the
update of optax ``scale_by_adam`` followed by ``scale_by_learning_rate``.
:func:`clip_grad_global_norm` is optax's ``clip_by_global_norm`` (LAFC's
``gc`` flag, max_norm 10 — LAFC/networks/network.py:131-134).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch


def step_decay(base_lr: float, decay_interval: int,
               gamma: float = 0.1) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        return base_lr * gamma ** (step // decay_interval)
    return schedule


def warmup_step_decay(base_lr: float, decay_interval: int,
                      gamma: float = 0.1, warmup: Optional[int] = None,
                      world_size: int = 1) -> Callable[[int], float]:
    decay = step_decay(base_lr, decay_interval, gamma)
    if not warmup:
        return decay

    def schedule(step: int) -> float:
        if step < warmup // world_size:
            return base_lr * (step + 1) / warmup   # reference slope quirk
        return decay(step)
    return schedule


def make_adam(params: Iterable[torch.nn.Parameter], beta1: float = 0.9,
              beta2: float = 0.999) -> torch.optim.Adam:
    """Adam with the reference betas; its lr is set per step by
    :func:`set_lr`."""
    return torch.optim.Adam(params, lr=0.0, betas=(beta1, beta2), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def clip_grad_global_norm(params: Iterable[torch.nn.Parameter],
                          max_norm: float) -> torch.Tensor:
    """Clip the gradients in place by their global norm, as optax's
    ``clip_by_global_norm`` does: left alone below ``max_norm``, scaled
    by ``max_norm / norm`` at or above it, with no epsilon (unlike
    ``torch.nn.utils.clip_grad_norm_``, which divides by norm + 1e-6).
    Stays on the device (no host sync). Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
