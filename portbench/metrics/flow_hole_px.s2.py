"""Flow-hole pixels a clip that s2 completes (LAFC's hole over both flow
directions), from the program's counter ``flow_hole_px`` over the
profiled clip."""

from portbench.spans import counter


def read(ctx):
    return counter(ctx, "infer", "flow_hole_px", "px/clip")
