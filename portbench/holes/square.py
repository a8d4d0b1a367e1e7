"""A ``size`` x ``size`` square hole at (``y0``, ``x0``) in the first
frame, moving ``pan`` px a frame with the background: the same hole in
every clip of the pool."""

from portbench.traffic import square_masks


def masks(hole: dict, i: int, n: int, h: int, w: int, pan: int):
    return square_masks(n, h, w, hole["size"], hole["y0"], hole["x0"], pan)
