"""Peak device memory allocated over the window, in GiB."""


def read(ctx):
    if ctx["kind"] != "infer" or "trace" not in ctx:
        return None
    return ctx["peak_bytes"] / 2 ** 30, "GiB"
