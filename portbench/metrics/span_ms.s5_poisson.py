"""Milliseconds a clip in stage s5 (Poisson blending, on the host), from
the host duration of the program's span over the profiled clip (the
stage clock synchronizes at both edges). The profiler slows the host, so
this reads above the window's ``stage_ms.s3_s5_host`` share."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "infer", "s5_poisson", host=True)
