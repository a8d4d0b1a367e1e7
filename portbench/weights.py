"""Random weights from the run's seed, made on the card in one
``torch.randn`` call a model and handed, as state dicts, to the
program and to the reference alike.

The names and shapes come from the reference models built on the
``meta`` device; the scales are the port's own init rules (``init_raft``,
``init_kaiming``, ``init_normal`` of ``fgt_tpu_torch``): He fan-out for
RAFT's encoders, LeCun for its update block, He fan-in for LAFC, the
LAFC-single oracle and the discriminator, N(0, 0.02) for the FGT
generator; zero biases, unit norm scales, identity batch norms, unit
random spectral-norm vectors.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from portbench.reference.blocks import FrozenBatchNorm, SNConv


def _fan(w_shape, mode: str) -> int:
    rf = 1
    for d in w_shape[2:]:
        rf *= d
    return (w_shape[1] if mode == "in" else w_shape[0]) * rf


def he(mode: str):
    return lambda name, shape: (2.0 / _fan(shape, mode)) ** 0.5


def raft_std(name: str, shape) -> float:
    if name.startswith("update_block."):
        return (1.0 / _fan(shape, "in")) ** 0.5
    return he("out")(name, shape)


def normal(std: float):
    return lambda name, shape: std


def make_state(model: nn.Module, std, gen: torch.Generator,
               dtype=torch.float32, scale: dict = None) -> dict:
    """The state dict of ``model`` (built on any device; only names and
    shapes are read) filled by the rules above on ``gen``'s device;
    ``scale`` multiplies the named random leaves' standard deviation."""
    scale = scale or {}
    dev = gen.device
    randoms, fixed = [], {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        tensors = dict(m.named_parameters(recurse=False))
        tensors.update(dict(m.named_buffers(recurse=False)))
        for n, t in tensors.items():
            key = pre + n
            if isinstance(m, SNConv) and n in ("weight_u", "weight_v"):
                randoms.append((key, t.shape, None))
            elif n in ("weight", "weight_orig") and isinstance(
                    m, (nn.Conv2d, nn.Conv3d, nn.Linear, SNConv)):
                randoms.append((key, t.shape,
                                std(key, t.shape) * scale.get(key, 1.0)))
            elif n in ("weight", "running_var") and isinstance(
                    m, (nn.LayerNorm, FrozenBatchNorm)):
                fixed[key] = torch.ones(t.shape, device=dev, dtype=dtype)
            elif n in ("bias", "running_mean"):
                fixed[key] = torch.zeros(t.shape, device=dev, dtype=dtype)
            else:
                raise ValueError(f"no init rule for {key}")
    total = sum(s.numel() for _, s, _ in randoms)
    flat = torch.randn(total, generator=gen, device=dev)
    state, at = {}, 0
    for key, shape, scale in randoms:
        v = flat[at:at + shape.numel()].view(shape)
        at += shape.numel()
        v = v / (torch.linalg.vector_norm(v) + 1e-12) if scale is None \
            else v * scale
        state[key] = v.to(dtype)
    state.update(fixed)
    return {k: state[k] for k in model.state_dict()}
