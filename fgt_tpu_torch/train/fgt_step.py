"""FGT GAN training step: alternating discriminator / generator update —
counterpart of ``fgt_tpu/train/fgt_step.py`` (reference hot loop
FGT/networks/network.py:86-157).

One step:

  1. the frozen LAFC-single oracle completes the corrupted flows under
     ``no_grad`` (skipped when there is no oracle);
  2. flows are normalized per (batch, frame, channel) by their signed max;
  3. ONE generator forward; its output, composited and detached, feeds
     the D update: hinge on (real, fake), two D calls that each run one
     spectral-norm power iteration;
  4. the G loss runs against the UPDATED discriminator without an SN
     update: hinge generator term plus masked/valid mean-normalized L1,
     with the reference's L1M/L1V weights swapped between the terms
     (network.py:150-151; both default to 1). Its gradient is taken with
     ``torch.autograd.grad`` over the generator's parameters only, so D
     collects nothing from it.

The generator runs as the JAX step applies it, never in train mode: a
BN layer normalises with its running statistics, and SN's u, v never
iterate. The JAX step hands Adam the generator's whole variable tree, so
BN's running mean and var are optimised by their gradients like the
weights; the port's ``ops/conv_blocks.BatchNorm`` holds them as
Parameters, so they are among ``gen.parameters()`` here, in the
mixed-precision cast, the gradient average and the checkpoints. SN's u,
v get zero gradients in JAX (``stop_gradient``), so Adam leaves them;
here they are buffers, outside the optimizer.

``bi_mode`` trains on both flow directions where the reference raises
NotImplementedError (network.py:106-107): ``fuse`` completes both and
averages them as (fwd − bwd) / 2, ``alternate`` takes forward flows on
even steps and backward flows on odd ones.

Data parallelism (``utils/dist.py``): each rank steps on its shard of
the global batch; the D and the G gradients are each averaged over the
ranks of ``group`` (the dp group; the world by default) before their
Adam updates, so every replica takes the JAX step's update on the global
batch. The spectral-norm u, v follow the weights only, so they stay
equal across the ranks.

Tensor and sequence parallelism (``parallel/``): the ranks of one tp and
sp group step on the same batch. A tensor-parallel generator holds its
slices of the sharded leaves; its replicated leaves get whole, equal
gradients through Megatron's *f* and are not reduced over tp. Under
sequence parallelism each rank back-propagates only its frames, so the
generator's gradients are first summed over ``sp_group``. The
discriminator and the losses run on the gathered output, the same on
every rank of a dp group.

Mixed precision (``train/precision.py``, as the JAX step's
``compute_dtype``): the generator and oracle forwards run on bf16 copies
of their parameters and inputs and their outputs come back as f32; D,
the optimizer state and the losses stay f32.

Under a profiler or ``enable_spans`` (``utils/profiling.py``) a step is
a root span ``fgt_step`` over the phases ``oracle`` (1-2),
``g_forward``, ``d_update`` (3), ``g_backward`` (4) and ``g_adam``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn

from fgt_tpu_torch.train import losses, precision
from fgt_tpu_torch.train.schedules import set_lr
from fgt_tpu_torch.utils.dist import average_grads, sum_grads
from fgt_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class FGTLossWeights:
    L1M: float = 1.0
    L1V: float = 1.0
    adv: float = 0.01
    gan_kind: str = "hinge"


def norm_flows_nhwc(flows: torch.Tensor) -> torch.Tensor:
    """Per (batch, frame, channel) signed-max normalization over space
    (reference network.py:80-84, NOT abs-max); a zero max divides by 1."""
    b, t, h, w, c = flows.shape
    fmax = flows.reshape(b, t, h * w, c).amax(dim=2)
    fmax = torch.where(fmax == 0, torch.ones_like(fmax), fmax)
    return flows / fmax[:, :, None, None, :]


class FGTTrainStep:
    """``step(batch) -> metrics``; updates ``gen`` and ``disc`` in place.

    * gen(masked_frames, flows, masks) -> [B, T, H, W, 3] in [-1, 1];
    * disc(video, sn_update) -> patch logits;
    * flow_model(flows [BT, H, W, 2], masks [BT, H, W, 1], with_edge)
      -> (flows, edge), or None to train on the batch's flows as given.

    ``batch``: frames [B, T, H, W, 3] in [-1, 1], masks [B, T, H, W, 1]
    and flows [B, T, H, W, 2] (with ``bi_mode``: flows_fwd and flows_bwd)
    on the models' device. ``schedule(step)`` sets both optimizers' lr
    before their updates; ``step`` counts the steps taken, from 0.
    """

    def __init__(self, gen: nn.Module, disc: nn.Module,
                 flow_model: Optional[nn.Module],
                 g_opt: torch.optim.Optimizer, d_opt: torch.optim.Optimizer,
                 schedule: Optional[Callable[[int], float]] = None,
                 weights: FGTLossWeights = FGTLossWeights(),
                 bi_mode: Optional[str] = None,
                 mixed_precision: bool = False, group=None, sp_group=None):
        if bi_mode not in (None, "fuse", "alternate"):
            raise ValueError(f"unknown bi_mode: {bi_mode!r}")
        self.gen, self.disc, self.flow_model = gen, disc, flow_model
        self.g_opt, self.d_opt = g_opt, d_opt
        self.schedule = schedule
        self.weights = weights
        self.bi_mode = bi_mode
        self.mixed_precision = mixed_precision
        self.group, self.sp_group = group, sp_group
        self.g_params = [p for p in gen.parameters() if p.requires_grad]
        self.step = 0

    def complete_flows(self, flows: torch.Tensor,
                       masks: torch.Tensor) -> torch.Tensor:
        if self.flow_model is None:
            return flows
        b, t, h, w, c = flows.shape
        with torch.no_grad():
            out, _ = precision.forward(
                self.flow_model, self.mixed_precision,
                flows.reshape(b * t, h, w, c), masks.reshape(b * t, h, w, 1),
                with_edge=False)
        return out.float().reshape(b, t, h, w, c)

    def _flows(self, batch: dict, masks: torch.Tensor) -> torch.Tensor:
        if self.bi_mode == "fuse":
            fwd = self.complete_flows(batch["flows_fwd"], masks)
            bwd = self.complete_flows(batch["flows_bwd"], masks)
            return (fwd - bwd) / 2.0
        if self.bi_mode == "alternate":
            key = "flows_fwd" if self.step % 2 == 0 else "flows_bwd"
            return self.complete_flows(batch[key], masks)
        return self.complete_flows(batch["flows"], masks)

    def _d_loss(self, real: torch.Tensor, fake: torch.Tensor):
        kind = self.weights.gan_kind
        loss_r = losses.adversarial_loss(self.disc(real, sn_update=True),
                                         True, True, kind)
        loss_f = losses.adversarial_loss(self.disc(fake, sn_update=True),
                                         False, True, kind)
        return (loss_r + loss_f) / 2.0, loss_r, loss_f

    def __call__(self, batch: dict) -> dict:
        frames, masks = batch["frames"], batch["masks"]
        with span("fgt_step", device=frames.device, step=self.step):
            return self._step(batch, frames, masks)

    def _step(self, batch: dict, frames: torch.Tensor,
              masks: torch.Tensor) -> dict:
        w = self.weights
        with span("oracle"):
            flows = norm_flows_nhwc(self._flows(batch, masks))
        lr = self.schedule(self.step) if self.schedule else None

        with span("g_forward"):
            filled = precision.forward(self.gen, self.mixed_precision,
                                       frames * (1 - masks), flows,
                                       masks).float()
            comp_detached = (filled * masks + frames * (1 - masks)).detach()

        with span("d_update"):
            self.d_opt.zero_grad(set_to_none=True)
            dis_loss, d_real, d_fake = self._d_loss(frames, comp_detached)
            dis_loss.backward()
            average_grads(self.disc.parameters(), self.group)
            if lr is not None:
                set_lr(self.d_opt, lr)
            self.d_opt.step()

        with span("g_backward"):
            comp = filled * masks + frames * (1 - masks)
            gan = losses.adversarial_loss(self.disc(comp, sn_update=False),
                                          True, False, w.gan_kind)
            l1_valid = losses.l1_normalized(filled, frames, 1 - masks,
                                            self.group)
            l1_masked = losses.l1_normalized(filled, frames, masks,
                                             self.group)
            # the reference swaps L1M/L1V between the terms (module
            # docstring)
            gen_loss = l1_valid * w.L1M + l1_masked * w.L1V + gan * w.adv
            grads = torch.autograd.grad(gen_loss, self.g_params,
                                        materialize_grads=True)
            for p, g in zip(self.g_params, grads):
                p.grad = g
            if self.sp_group is not None:
                sum_grads(self.g_params, self.sp_group)
            average_grads(self.g_params, self.group)
        with span("g_adam"):
            if lr is not None:
                set_lr(self.g_opt, lr)
            self.g_opt.step()
        self.step += 1
        return {k: v.detach() for k, v in (
            ("dis_loss", dis_loss), ("dis_real", d_real),
            ("dis_fake", d_fake), ("gen_loss", gen_loss), ("adv", gan),
            ("l1_valid", l1_valid), ("l1_masked", l1_masked))}
