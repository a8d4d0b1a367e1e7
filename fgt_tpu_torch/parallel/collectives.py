"""The collectives of tensor and sequence parallelism, written out —
what XLA's SPMD partitioner inserts into the JAX package's programs
(``fgt_tpu/parallel/partition.py``, ``fgt_tpu/ops/attention.py``'s
sharding constraints). Each is a ``torch.autograd.Function`` on a
process group:

* :func:`copy_to_group` — identity forward, all-reduce backward
  (Megatron's *f*, in front of a column-parallel layer);
* :func:`reduce_from_group` — all-reduce forward, identity backward
  (Megatron's *g*, behind a row-parallel layer);
* :func:`all_to_all` — dim-0 all-to-all with explicit split sizes, whose
  backward is the reverse all-to-all (Ulysses' re-scatter);
* :func:`gather_frames` — all-gather on dim 0 with uneven shares, whose
  backward returns this rank's slice of the gradient: every rank
  computes the same loss on the gathered tensor, so the gradient of its
  slice is already whole (no reduce-scatter).

A group of one rank, or ``None``, makes each the identity and issues no
collective.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _all_to_all(x: torch.Tensor, out_splits: Sequence[int],
                in_splits: Sequence[int], group) -> torch.Tensor:
    x = x.contiguous()
    y = x.new_empty((sum(out_splits), *x.shape[1:]))
    dist.all_to_all_single(y, x, list(out_splits), list(in_splits),
                           group=group)
    return y


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.splits, ctx.group = (out_splits, in_splits), group
        return _all_to_all(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        return _all_to_all(g, in_splits, out_splits, ctx.group), None, \
            None, None


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, splits, group):
        rank = dist.get_rank(group)
        ctx.start = sum(splits[:rank])
        ctx.n = splits[rank]
        most = max(splits)
        x = x.contiguous()
        if x.shape[0] < most:
            x = torch.cat([x, x.new_zeros((most - x.shape[0],
                                           *x.shape[1:]))])
        parts = [torch.empty_like(x) for _ in splits]
        dist.all_gather(parts, x, group=group)
        return torch.cat([p[:n] for p, n in zip(parts, splits)])

    @staticmethod
    def backward(ctx, g):
        return g[ctx.start:ctx.start + ctx.n], None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceFromGroup.apply(x, group)


def all_to_all(x: torch.Tensor, out_splits: Sequence[int],
               in_splits: Sequence[int], group) -> torch.Tensor:
    """Rows ``in_splits[j]`` of ``x`` (in order) go to rank j of
    ``group``; the result holds ``out_splits[i]`` rows from each rank i,
    in rank order."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, tuple(out_splits), tuple(in_splits), group)


def gather_frames(x: torch.Tensor, splits: Sequence[int],
                  group) -> torch.Tensor:
    """Concatenate every rank's ``x`` (``splits[i]`` rows on rank i) on
    dim 0, in rank order, on every rank."""
    if group_size(group) == 1:
        return x
    return _GatherFrames.apply(x, tuple(splits), group)


def frame_splits(n: int, parts: int) -> list:
    """The shares of ``n`` frames over ``parts`` ranks, as
    ``torch.tensor_split`` cuts them (the first ``n % parts`` one
    larger): contiguous, uneven where ``parts`` does not divide ``n``."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


def row_parallel_linear(linear: torch.nn.Linear, x: torch.Tensor,
                        group) -> torch.Tensor:
    """``linear(x)`` for a row-parallel layer: this rank's input rows of
    the weight against its slice of ``x``, summed over ``group``
    (Megatron's *g*), then the replicated bias, added once. Without a
    group, ``linear(x)`` itself."""
    if group_size(group) == 1:
        return linear(x)
    out = reduce_from_group(torch.nn.functional.linear(x, linear.weight),
                            group)
    return out if linear.bias is None else out + linear.bias
