"""Hole pixels a clip that s5's Poisson blending leaves to FGT to
synthesize, from the program's counter ``fgt_px`` over the profiled
clip."""

from portbench.spans import counter


def read(ctx):
    return counter(ctx, "infer", "fgt_px", "px/clip")
