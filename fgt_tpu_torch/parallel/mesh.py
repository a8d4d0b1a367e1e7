"""The (dp, tp, sp) process grid — counterpart of
``fgt_tpu/parallel/mesh.py``'s ``make_mesh``, in PyTorch's idiom: one
process per card and a ``torch.distributed`` group per mesh axis, where
the JAX package lays a device mesh under one controller.

Ranks are laid out row-major as (dp, tp, sp), sp innermost, as
``make_mesh`` orders its devices: rank ``r`` sits at
``(r // (tp·sp), (r // sp) % tp, r % sp)``. The groups of every axis are
made with ``dist.new_group`` in the same order on every rank (each rank
must take part in every ``new_group`` call, its own group or not).
Without a process group the mesh is one rank, every group is ``None``
and no collective is issued.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from fgt_tpu_torch.utils import dist as udist

AXES = ("dp", "tp", "sp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid: the axis ``sizes`` and ``coords``
    (each keyed by axis name) and the ``groups`` of the ranks that share
    this rank's coordinates on the other two axes."""

    sizes: dict
    coords: dict
    groups: dict

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]

    @property
    def dp(self) -> int:
        return self.sizes["dp"]

    @property
    def tp(self) -> int:
        return self.sizes["tp"]

    @property
    def sp(self) -> int:
        return self.sizes["sp"]


def axis_ranks(sizes: dict, axis: str) -> list:
    """Every group of ``axis``: lists of global ranks, in a fixed order
    (by the other two coordinates, row-major)."""
    other = [a for a in AXES if a != axis]
    out = []
    for i in range(sizes[other[0]]):
        for j in range(sizes[other[1]]):
            ranks = []
            for k in range(sizes[axis]):
                c = {other[0]: i, other[1]: j, axis: k}
                ranks.append((c["dp"] * sizes["tp"] + c["tp"]) * sizes["sp"]
                             + c["sp"])
            out.append(ranks)
    return out


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1) -> Mesh:
    """The mesh over the world's ranks; ``dp`` defaults to
    world // (tp·sp), and dp·tp·sp must equal the world's size."""
    world, rank = udist.world_size(), udist.rank()
    if dp is None:
        dp = world // (tp * sp)
    assert dp * tp * sp == world, \
        f"dp({dp}) * tp({tp}) * sp({sp}) != #ranks({world})"
    sizes = {"dp": dp, "tp": tp, "sp": sp}
    coords = {"dp": rank // (tp * sp), "tp": (rank // sp) % tp,
              "sp": rank % sp}
    groups = dict.fromkeys(AXES)
    if udist.initialized():
        for axis in AXES:
            for ranks in axis_ranks(sizes, axis):
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    return Mesh(sizes, coords, groups)
