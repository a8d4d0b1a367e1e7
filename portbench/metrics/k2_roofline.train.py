"""K2 (attention forward) in the training step: the least time the card
could take for the calls (``portbench/counts.py``) over the device time
of the kernels launched inside their call boundaries, in %."""

from portbench.common import roofline_share


def read(ctx):
    return roofline_share(ctx, ("k2",), "train")
