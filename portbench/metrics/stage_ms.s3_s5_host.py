"""Milliseconds a clip in the host stages s3 (gradients), s4 (flowNN)
and s5 (Poisson) together, from the harness's stage clock over the
un-profiled window."""

STAGES = ("s3_gradients", "s4_flownn", "s5_poisson")


def read(ctx):
    times = ctx.get("stages_s", {})
    if ctx["kind"] != "infer" or not all(s in times for s in STAGES):
        return None
    return 1e3 * sum(times[s] for s in STAGES) / ctx["items"], "ms/clip"
