"""Milliseconds a clip in s1's RAFT encoder over every frame
(``s1.encode``), from the program's span over the profiled clip: the
span's ``device_ms`` (its interval on the card's timeline, busy or
waiting), its host duration where it has none."""

from portbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "infer", "s1.encode")
