"""Milliseconds a step in the discriminator's update: both its calls, the
backward, Adam (``d_update``), from the program's ``device_ms`` (the
span's interval on the card's timeline, busy or waiting; its host
duration where it has none) over the profiled steps."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "train", "d_update")
