"""Milliseconds a step in the generator's losses against the updated
discriminator and their gradients (``g_backward``), from the program's
``device_ms`` (the span's interval on the card's timeline, busy or
waiting; its host duration where it has none) over the profiled steps."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "g_backward")
