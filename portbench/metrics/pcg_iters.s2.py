"""Iterations a clip of s2's device diffusion (the multigrid-preconditioned
CG of ``fgt_tpu_torch/ops/diffusion.py``, both flow directions), from
the program's counter ``pcg_iters`` over the profiled clip. Each
iteration syncs the host once."""

from portbench.spans import counter


def read(ctx):
    return counter(ctx, "infer", "pcg_iters", "iterations/clip")
