"""Model FLOPs a step (counted over the plain reference, portbench/counts.py)
times those the un-profiled window completed, over its seconds and the
bf16 dense peak, in %."""

from portbench.common import PEAK_BF16_FLOPS


def read(ctx):
    if ctx["kind"] != "train" or "flops_per_item" not in ctx:
        return None
    rate = ctx["flops_per_item"] * ctx["items"] / ctx["window_s"]
    return 100.0 * rate / PEAK_BF16_FLOPS, "%"
