"""Model FLOPs of the clips the un-profiled window completed (each counted
at its length over the plain reference, portbench/counts.py), over the
window's seconds and the bf16 dense peak, in %."""

from portbench.common import PEAK_BF16_FLOPS


def read(ctx):
    if ctx["kind"] != "infer" or "window_flops" not in ctx:
        return None
    rate = ctx["window_flops"] / ctx["window_s"]
    return 100.0 * rate / PEAK_BF16_FLOPS, "%"
