"""Milliseconds a step in the bf16 copies of the oracle's and the
generator's parameters and buffers, summed over the step's calls
(``cast``, inside ``oracle`` and ``g_forward``), from the program's
``device_ms`` (the span's interval on the card's timeline, busy or
waiting; its host duration where it has none) over the profiled steps."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "cast")
