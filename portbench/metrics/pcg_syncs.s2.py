"""Host reads of the convergence flag a clip of s2's device diffusion
made (``fgt_tpu_torch/ops/diffusion.py``, both flow directions), from
the program's counter ``pcg_syncs`` over the profiled clip: on the card
one before the first chunk of K7's iterations and one after each chunk;
the plain version's one an iteration and one more. A program without the
counter gives nothing."""

from portbench.spans import counter


def read(ctx):
    return counter(ctx, "infer", "pcg_syncs", "syncs/clip")
