"""The FGT GAN training step of the plain reference: ``FGTTrainStep`` of
``fgt_tpu_torch/train/fgt_step.py`` (commit ac5eac9) without its data-,
tensor- and sequence-parallel reductions and its mixed precision, with
the T-PatchGAN of ``fgt_tpu_torch/models/discriminator.py`` and the
hinge and masked L1 losses of ``fgt_tpu_torch/train/losses.py`` (same
commit), and ``torch.optim.Adam`` in its single-tensor form.

One step: the frozen LAFC-single oracle completes the flows; flows are
normalised per (batch, frame, channel) by their signed max; one
generator forward; the discriminator takes a hinge step on (real,
composited fake), each of its two calls running one spectral-norm power
iteration; the generator takes a step on masked and valid L1 (weights
swapped as the reference swaps them) plus 0.01 x the hinge generator
term against the updated discriminator.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.blocks import SNConv, leaky_relu_02
from portbench.reference.fgt import FGT
from portbench.reference.lafc import LAFCSingle


class TemporalPatchGAN(nn.Module):
    def __init__(self, in_channels: int = 3, dist_cnum: int = 32):
        super().__init__()
        nf = dist_cnum
        widths = [in_channels, nf, nf * 2, nf * 4, nf * 4, nf * 4]
        layers = []
        for cin, cout in zip(widths[:-1], widths[1:]):
            layers += [SNConv(cin, cout, (3, 5, 5), (1, 2, 2), (1, 2, 2)),
                       nn.LeakyReLU(0.2)]
        layers.append(nn.Conv3d(nf * 4, nf * 4, (3, 5, 5), (1, 2, 2),
                                (1, 2, 2)))
        self.conv = nn.Sequential(*layers)

    def forward(self, x, sn_update: bool = False):
        y = x.permute(0, 4, 1, 2, 3)
        for m in self.conv[:-1:2]:
            y = leaky_relu_02(m(y, sn_update=sn_update))
        return self.conv[-1](y).permute(0, 2, 3, 4, 1)


def hinge_d(outputs, is_real: bool):
    return torch.mean(torch.relu(1.0 + (-1.0 if is_real else 1.0) * outputs))


def l1_normalized(pred, target, mask):
    return torch.mean(torch.abs(pred * mask - target * mask)) / torch.clamp(
        torch.mean(mask), min=1e-8)


def norm_flows_nhwc(flows):
    b, t, h, w, c = flows.shape
    fmax = flows.reshape(b, t, h * w, c).amax(dim=2)
    fmax = torch.where(fmax == 0, torch.ones_like(fmax), fmax)
    return flows / fmax[:, :, None, None, :]


class RefTrainStep:
    """``step(batch) -> dict`` of the losses (floats) and, for the
    comparison, the oracle's flows and the generator's output."""

    def __init__(self, gen: FGT, disc: TemporalPatchGAN, oracle: LAFCSingle,
                 lr: float, betas, adv: float = 0.01, l1m: float = 1.0,
                 l1v: float = 1.0):
        self.gen, self.disc, self.oracle = gen, disc, oracle
        self.adv, self.l1m, self.l1v = adv, l1m, l1v
        self.g_params = [p for p in gen.parameters() if p.requires_grad]
        self.g_opt = torch.optim.Adam(self.g_params, lr=lr, betas=betas,
                                      eps=1e-8, foreach=False)
        self.d_opt = torch.optim.Adam(disc.parameters(), lr=lr, betas=betas,
                                      eps=1e-8, foreach=False)

    def __call__(self, batch: dict, optimize: bool = True) -> dict:
        frames, masks, flows = batch["frames"], batch["masks"], batch["flows"]
        b, t, h, w, c = flows.shape
        with torch.no_grad():
            done = self.oracle(flows.reshape(b * t, h, w, c),
                               masks.reshape(b * t, h, w, 1))
        done = done.float().reshape(b, t, h, w, c)
        filled = self.gen(frames * (1 - masks), norm_flows_nhwc(done),
                          masks).float()
        comp_d = (filled * masks + frames * (1 - masks)).detach()
        self.d_opt.zero_grad(set_to_none=True)
        d_real = hinge_d(self.disc(frames, sn_update=True), True)
        d_fake = hinge_d(self.disc(comp_d, sn_update=True), False)
        dis_loss = (d_real + d_fake) / 2.0
        dis_loss.backward()
        if optimize:
            self.d_opt.step()
        comp = filled * masks + frames * (1 - masks)
        gan = torch.mean(-self.disc(comp, sn_update=False))
        gen_loss = (l1_normalized(filled, frames, 1 - masks) * self.l1m
                    + l1_normalized(filled, frames, masks) * self.l1v
                    + gan * self.adv)
        grads = torch.autograd.grad(gen_loss, self.g_params,
                                    materialize_grads=True)
        for p, g in zip(self.g_params, grads):
            p.grad = g
        if optimize:
            self.g_opt.step()
        return {"gen_loss": gen_loss.detach(), "dis_loss": dis_loss.detach(),
                "oracle_flows": done.detach(), "gen_out": filled.detach()}
