"""Data parallelism over ``torch.distributed`` — the counterpart of
``fgt_tpu/parallel/mesh.py``'s ``dp`` axis, in PyTorch's idiom: one
process per card, each holding a replica of the parameters and a shard
of the global batch.

The JAX package's step sees the global batch in one program, so every
batch mean in a loss and the gradient (a ``psum`` over ``dp``) are
global. Here each process computes on its shard, and:

* :func:`global_mean` makes a loss's data-only normaliser global (the
  mean hole area of ``l1_normalized`` and the census loss), so that the
  mean over ranks of the per-rank losses is the global batch's loss;
* :func:`average_grads` averages the gradients over the ranks before
  the clip and the optimizer;
* :func:`broadcast_module` starts every replica from rank 0's
  parameters and buffers;
* :func:`mean_scalars` gives the metrics' means over the ranks.

Each takes a ``group`` (default: the world, plain data parallelism):
under tensor and sequence parallelism (``parallel/mesh.py``) the trainer
passes its dp group, and :func:`sum_grads` sums the generator's
gradients over the sp group first, each sp rank having back-propagated
only its frames. Without a process group each is the identity and
issues no collective; in a group, of one rank too, each issues its
collective. The rendezvous
(:func:`init_from_flags`) takes the JAX CLI's ``--coordinator
host:port --num_processes N --process_id i``, ``torchrun``'s ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``, or a group the
caller already initialised.
"""

from __future__ import annotations

import os
from typing import Iterable

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def init_from_flags(coordinator: str = "", num_processes: int = 0,
                    process_id: int = -1,
                    device: str = "cuda") -> str:
    """Initialise the process group, if the flags or the environment ask
    for one and none exists: from ``coordinator`` / ``num_processes`` /
    ``process_id`` (as ``jax.distributed.initialize`` takes them; both
    the coordinator and a positive count are needed, as in the JAX CLI),
    else from ``torchrun``'s ``RANK`` and ``WORLD_SIZE``; NCCL for a
    ``cuda`` device, gloo for the CPU. Returns the device this process
    takes: ``cuda:{rank % device_count}`` on the card in a group,
    ``device`` otherwise."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if not initialized():
        if coordinator and num_processes > 0:
            if not 0 <= process_id < num_processes:
                raise ValueError(f"--process_id {process_id} not in "
                                 f"[0, {num_processes})")
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id)
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            return device
    if torch.device(device).type != "cuda":
        return device
    local = torch.device("cuda", rank() % torch.cuda.device_count())
    torch.cuda.set_device(local)
    return str(local)


def ranks_from_flags(coordinator: str = "", num_processes: int = 0) -> int:
    """The number of ranks :func:`init_from_flags` would join (or the
    group's, when one exists), known before any rendezvous."""
    if initialized():
        return world_size()
    if coordinator and num_processes > 0:
        return num_processes
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return 1


def shutdown() -> None:
    if initialized():
        dist.destroy_process_group()


def global_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the ranks of ``group`` of a scalar that carries no
    gradient (a mean over this rank's shard: over equal shards, the
    global batch's mean); ``x`` itself without a process group."""
    if not initialized():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


def _reduce_grads(params: Iterable[torch.nn.Parameter], group,
                  mean: bool) -> None:
    if not initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def average_grads(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Replace each gradient by its mean over the ranks of ``group`` (one
    all-reduce of the flattened gradients): the gradient of the global
    batch's loss when each rank's loss is its shard's share."""
    _reduce_grads(params, group, mean=True)


def sum_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Replace each gradient by its sum over the ranks of ``group``: the
    whole gradient when each rank back-propagated its part of the
    batch (sequence parallelism's frames)."""
    _reduce_grads(params, group, mean=False)


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and floating buffers (spectral-norm u, v)
    into every replica."""
    if not initialized():
        return
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, 0)


def mean_scalars(metrics: dict, group=None) -> dict:
    """{name: float}, each the mean over the ranks of ``group`` of this
    rank's value (one all-reduce on the metrics' device)."""
    if not initialized():
        return {k: float(v) for k, v in metrics.items()}
    vals = torch.stack([torch.as_tensor(v).detach().float().reshape(())
                        for v in metrics.values()])
    dist.all_reduce(vals, group=group)
    vals = vals / dist.get_world_size(group)
    return {k: float(v) for k, v in zip(metrics, vals.tolist())}
