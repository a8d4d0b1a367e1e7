"""Milliseconds a step in the frozen LAFC-single oracle completing the
step's flows, and their normalisation (``oracle``), from the program's
``device_ms`` (the span's interval on the card's timeline, busy or
waiting; its host duration where it has none) over the profiled steps."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "oracle")
