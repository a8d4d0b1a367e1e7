"""Share of the profiled stretch in which no kernel, copy or set ran on
the card (1 - the union of their intervals over the stretch), in %."""


def read(ctx):
    if ctx["kind"] != "infer" or "trace" not in ctx:
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]), "%"
