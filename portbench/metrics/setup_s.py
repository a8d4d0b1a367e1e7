"""Seconds from the process's start to the window's: imports, the
program's libraries (built on a checkout's first run), weights, traffic
pools, the cold clip or steps."""


def read(ctx):
    return ctx["setup_s"], "s"
