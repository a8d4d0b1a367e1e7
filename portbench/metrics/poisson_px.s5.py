"""Unknowns a clip that s5's Poisson blending solves (the hole pixels of
every frame it runs on), from the program's counter ``poisson_px`` over
the profiled clip."""

from portbench.spans import counter


def read(ctx):
    return counter(ctx, "infer", "poisson_px", "unknowns/clip")
