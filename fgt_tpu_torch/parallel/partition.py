"""Tensor-parallel partition rules for the FGT generator (Megatron) —
counterpart of ``fgt_tpu/parallel/partition.py``, on the port's
``state_dict`` names and torch's ``[out, in]`` Linear layout.

Column-parallel (output features, i.e. whole heads or whole fold
channels, split over tp): the attention's q/k/v embeddings and the
fusion FFN's up-projection ``conv1``. Row-parallel (input features
split): the attention's ``output_linear`` and the FFN's down-projection
``conv2.2``; their biases stay replicated and are added once, after the
all-reduce (the JAX rules have none for them either). The rules match
the temporal and the spatial ``attention`` alike, as the JAX rules do.

Where the JAX package hands the specs to XLA, the port slices the
leaves itself (:func:`shard_module`, :func:`shard_state`) and the
modules issue the collectives (``ops/attention.py``, ``ops/ffn.py``,
:mod:`fgt_tpu_torch.parallel.collectives`). A spec here is the dim a
leaf is split on over tp, or ``None`` (replicated). The FFN's hidden
axis is channel-major over k·k (``F.fold``'s layout), so a split at
multiples of k·k keeps whole fold channels on each rank; the overlap
counts of the fold are channel-independent.
"""

from __future__ import annotations

import logging
import re
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("fgt_tpu_torch")

# (state_dict name regex, dim split over tp). First match wins; no match
# -> replicated.
FGT_TP_RULES: Tuple[Tuple[str, int], ...] = (
    (r"attention\.(query|key|value)_embedding\.(weight|bias)$", 0),
    (r"attention\.output_linear\.weight$", 1),
    (r"ffn\.conv1\.(weight|bias)$", 0),
    (r"ffn\.conv2\.2\.weight$", 1),
)


def partition_specs(state: Dict[str, torch.Tensor], tp: int,
                    rules: Sequence[Tuple[str, int]] = FGT_TP_RULES
                    ) -> Dict[str, Optional[int]]:
    """{name: split dim or None} for every leaf of ``state`` at tensor-
    parallel degree ``tp``. A leaf whose dim ``tp`` does not divide is
    replicated, with one log line."""
    compiled = [(re.compile(pat), d) for pat, d in rules]
    specs = {}
    for name, leaf in state.items():
        specs[name] = None
        for pat, d in compiled:
            if pat.search(name):
                if tp > 1 and leaf.dim() > d and leaf.shape[d] % tp == 0:
                    specs[name] = d
                elif tp > 1:
                    logger.info("tp: %s shape %s not divisible by %d on "
                                "dim %d; replicating", name,
                                tuple(leaf.shape), tp, d)
                break
    return specs


def tp_param_fraction(state: Dict[str, torch.Tensor], tp: int,
                      rules: Sequence[Tuple[str, int]] = FGT_TP_RULES
                      ) -> float:
    """Fraction of the elements of ``state`` (full shapes) that are
    tp-sharded."""
    specs = partition_specs(state, tp, rules)
    total = sum(t.numel() for t in state.values())
    sharded = sum(t.numel() for k, t in state.items()
                  if specs[k] is not None)
    return sharded / max(total, 1)


def _map_sharded(state: dict, specs: dict, fn: Callable) -> dict:
    return {k: (fn(v, specs[k]) if specs.get(k) is not None else v)
            for k, v in state.items()}


def _slice(mesh):
    """fn(leaf, dim): this tp rank's slice of a full leaf, in storage of
    its own (a view would keep the full leaf alive)."""
    i = mesh.index("tp")
    return lambda v, d: v.chunk(mesh.tp, d)[i].clone(
        memory_format=torch.contiguous_format)


def _gather(mesh):
    """fn(leaf, dim): the full leaf from every tp rank's slice (an
    all-gather over the tp group; every rank must call it)."""
    def gather(v, d):
        parts = [torch.empty_like(v) for _ in range(mesh.tp)]
        dist.all_gather(parts, v.contiguous(), group=mesh.group("tp"))
        return torch.cat(parts, dim=d)
    return gather


def shard_state(state: Dict[str, torch.Tensor], mesh,
                full_specs: dict) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full ``state``; ``full_specs``: the specs
    of the full shapes."""
    return _map_sharded(state, full_specs, _slice(mesh))


def gather_state(state: Dict[str, torch.Tensor], mesh,
                 full_specs: dict) -> Dict[str, torch.Tensor]:
    """The full state from every tp rank's slices (every rank must call
    it); ``full_specs``: the specs of the full shapes."""
    return _map_sharded(state, full_specs, _gather(mesh))


def _map_optimizer_state(osd: dict, names: Sequence[str], specs: dict,
                         fn: Callable) -> dict:
    """``osd`` (a ``torch.optim`` state dict over parameters ``names``,
    in order) with ``fn(tensor, dim)`` applied to every per-parameter
    tensor (Adam's moments) of a sharded parameter."""
    state = {}
    for i, st in osd["state"].items():
        d = specs.get(names[int(i)])
        state[i] = {k: (fn(v, d) if d is not None and torch.is_tensor(v)
                        and v.dim() > 0 else v) for k, v in st.items()}
    return {"state": state, "param_groups": osd["param_groups"]}


def shard_optimizer_state(osd: dict, names: Sequence[str], mesh,
                          full_specs: dict) -> dict:
    """This rank's slice of a full optimizer state (resume)."""
    return _map_optimizer_state(osd, names, full_specs, _slice(mesh))


def gather_optimizer_state(osd: dict, names: Sequence[str], mesh,
                           full_specs: dict) -> dict:
    """The full optimizer state from every tp rank's (every rank must
    call it)."""
    return _map_optimizer_state(osd, names, full_specs, _gather(mesh))


def shard_module(model: torch.nn.Module, mesh) -> Dict[str, Optional[int]]:
    """Shard an FGT generator (``models.fgt.Model`` or ``FGT``) built
    from the full init, in place, over ``mesh``: every leaf a rule
    splits is cut to this rank's slice, the attention and FFN modules
    holding them run on their local heads / fold channels with their
    collectives on the tp group, and the generator takes the mesh for
    its sequence parallelism (``FGTConfig.seq_axis``). Returns the specs
    of the full shapes (what :func:`gather_state` needs)."""
    from fgt_tpu_torch.models.fgt import FGT
    from fgt_tpu_torch.ops.attention import TMHSA, FlowGuidedSWMHSA
    from fgt_tpu_torch.ops.ffn import FusionFeedForward

    specs = partition_specs(model.state_dict(), mesh.tp)
    local = _slice(mesh)
    for name, p in model.named_parameters():
        if specs[name] is not None:
            p.data = local(p.data, specs[name])
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(mod, (TMHSA, FlowGuidedSWMHSA)):
            keys = [f"{prefix}{k}" for k in (
                "query_embedding.weight", "key_embedding.weight",
                "value_embedding.weight", "output_linear.weight")]
        elif isinstance(mod, FusionFeedForward):
            keys = [f"{prefix}conv1.weight", f"{prefix}conv2.2.weight"]
        else:
            if isinstance(mod, FGT):
                mod.mesh = mesh
            continue
        split = {specs[k] is not None for k in keys}
        if len(split) != 1:
            raise ValueError(f"tp: {name} is sharded on some of {keys} only")
        if split.pop():
            mod.shard(mesh.group("tp"), mesh.tp)
    return specs
