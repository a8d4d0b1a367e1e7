"""Milliseconds a clip in stage s6_fgt, from the harness's stage clock
(synchronized at both edges) over the un-profiled window."""


def read(ctx):
    t = ctx.get("stages_s", {}).get("s6_fgt")
    if ctx["kind"] != "infer" or t is None:
        return None
    return 1e3 * t / ctx["items"], "ms/clip"
