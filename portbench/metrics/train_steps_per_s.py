"""Training steps the window completed, over its seconds (the last
step ends with a synchronize)."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx["items"] / ctx["window_s"], "steps/s"
