"""Iterations of s5's Poisson solve on the card (K6,
``fgt_tpu_torch/ops/poisson.py``: the most any frame and channel of the
clip's one launch ran), from the program's counter ``poisson_iters``
over the profiled clip. The parent has no such counter: nothing to
read."""

from portbench.spans import counter


def read(ctx):
    return counter(ctx, "infer", "poisson_iters", "iterations/clip")
