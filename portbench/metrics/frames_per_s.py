"""Frames of every clip the window completed, over its seconds."""


def read(ctx):
    if ctx["kind"] != "infer":
        return None
    return ctx["frames"] / ctx["window_s"], "frames/s"
