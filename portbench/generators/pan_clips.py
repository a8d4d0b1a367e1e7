"""A pool of ``pool`` video-extrapolation clips, sent in order and
cycled: each ``frames`` frames of smoothed noise panning ``pan_px`` a
frame, its background drawn from the run's seed. ``make`` returns a list
of (frames u8 [N, H, W, 3], None): extrapolation's hole is the canvas
border, which the entry makes itself."""

import numpy as np

from portbench.traffic import panning_background


def make(mix: dict, seed: int, device=None) -> list:
    rng = np.random.RandomState(seed % 2 ** 32)
    return [(panning_background(rng, mix["frames"], mix["height"],
                                mix["width"], mix["pan_px"]), None)
            for _ in range(mix["pool"])]
