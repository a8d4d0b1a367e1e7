"""LAFC / LAFC-single training step — counterpart of
``fgt_tpu/train/lafc_step.py`` (reference LAFC/networks/network.py:66-172).

Loss recipe: masked + valid L1 on the composited flow, first- and
second-order smoothness, the census (ternary) loss against the warped
shift frame, and the pos/neg-weighted edge loss
``edge_loss(filled) + 5 edge_loss(combined)``; optional global-norm
gradient clipping (max_norm 10, optax's rule). Under data parallelism the
gradients are averaged over the ranks before the clip and the Adam step
(the JAX step's gradient over the global batch). Under mixed precision the
model runs on bf16 copies (``train/precision.py``) and its outputs come
back in the batch's dtype (f32) before the losses.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn

from fgt_tpu_torch.train import losses, precision
from fgt_tpu_torch.train.schedules import clip_grad_global_norm, set_lr
from fgt_tpu_torch.utils.dist import average_grads


@dataclasses.dataclass
class LAFCLossWeights:
    L1M: float = 1.0
    sm: float = 1.0
    sm2: float = 1.0
    ternary: float = 0.01
    edge: float = 1.0


class LAFCTrainStep:
    """``step(batch) -> metrics``; updates ``model`` in place.

    ``batch`` (NHWC, window axis T = num_flows, on the model's device):
    flows and diffused_flows [B, T, H, W, 2], masks [B, T, H, W, 1],
    edges [B, H, W, 1], current_frame and shift_frame [B, H, W, 3] in
    [0, 1]. The target is the pivot ``t // 2``. With ``single`` the
    model is LAFC-single and sees the pivot's diffused flow and mask only
    (the JAX trainer's ``_single_window``). ``schedule(step)`` sets the
    lr before each update; ``step`` counts the steps taken, from 0.
    Metrics carry the JAX step's names: loss, l1_masked, l1_valid, sm1,
    sm2, ternary, edge.
    """

    def __init__(self, model: nn.Module, opt: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 weights: LAFCLossWeights = LAFCLossWeights(),
                 grad_clip: Optional[float] = None,
                 mixed_precision: bool = False, single: bool = False,
                 group=None):
        self.model, self.opt = model, opt
        self.group = group       # data-parallel ranks (None: the world)
        self.schedule = schedule
        self.weights = weights
        self.grad_clip = grad_clip
        self.mixed_precision = mixed_precision
        self.single = single
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.step = 0

    def losses(self, batch: dict) -> dict:
        """The loss terms and their weighted total (``loss``)."""
        w = self.weights
        flows, masks = batch["flows"], batch["masks"]
        t = flows.shape[1]
        target_flow = flows[:, t // 2]
        target_mask = masks[:, t // 2]
        inp_flows, inp_masks = batch["diffused_flows"], masks
        if self.single:
            inp_flows, inp_masks = inp_flows[:, t // 2], target_mask
        filled_flow, filled_edge = precision.forward(
            self.model, self.mixed_precision, inp_flows, inp_masks)
        # back to the batch's dtype (f32; f64 for a reference run)
        filled_flow = filled_flow.to(flows.dtype)
        filled_edge = filled_edge.to(flows.dtype)

        combined_flow = (target_flow * (1 - target_mask)
                         + filled_flow * target_mask)
        target_edge = batch["edges"]
        combined_edge = (target_edge * (1 - target_mask)
                         + filled_edge * target_mask)
        e_loss = (losses.edge_loss(filled_edge, target_edge)
                  + 5.0 * losses.edge_loss(combined_edge, target_edge))
        l1_masked = losses.l1_normalized(combined_flow, target_flow,
                                         target_mask, self.group)
        l1_valid = losses.l1_normalized(filled_flow, target_flow,
                                        1 - target_mask, self.group)
        sm1 = losses.smoothness_loss(combined_flow, target_mask)
        sm2 = losses.second_order_loss(combined_flow, target_mask)
        tern = losses.ternary_loss(combined_flow, target_flow, target_mask,
                                   batch["current_frame"],
                                   batch["shift_frame"], self.group)
        total = ((l1_masked + l1_valid) * w.L1M + sm1 * w.sm + sm2 * w.sm2
                 + tern * w.ternary + e_loss * w.edge)
        return {"loss": total, "l1_masked": l1_masked, "l1_valid": l1_valid,
                "sm1": sm1, "sm2": sm2, "ternary": tern, "edge": e_loss}

    def __call__(self, batch: dict) -> dict:
        metrics = self.losses(batch)
        self.opt.zero_grad(set_to_none=True)
        metrics["loss"].backward()
        average_grads(self.params, self.group)
        if self.grad_clip:
            clip_grad_global_norm(self.params, self.grad_clip)
        if self.schedule is not None:
            set_lr(self.opt, self.schedule(self.step))
        self.opt.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}
