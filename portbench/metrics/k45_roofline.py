"""K4 and K5 (attention backward) together: the least time the card could
take for the calls (``portbench/counts.py``) over the device time of the
kernels launched inside their call boundaries, in %."""

from portbench.common import roofline_share


def read(ctx):
    return roofline_share(ctx, ("k4", "k5"), "train")
