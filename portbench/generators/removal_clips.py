"""A pool of ``pool`` object-removal clips, sent in order and cycled:
clip ``i`` is ``frames`` frames long (a number, or a list whose entry
``i % len`` is taken) of smoothed noise panning ``pan_px`` a frame, its
background drawn from the run's seed, with a hole made by
``portbench/holes/<hole.kind>.py``. ``make`` returns a list of
(frames u8 [N, H, W, 3], masks u8 [N, H, W])."""

import numpy as np

from portbench import common
from portbench.traffic import panning_background


def make(mix: dict, seed: int, device=None) -> list:
    h, w, pan = mix["height"], mix["width"], mix["pan_px"]
    lengths = mix["frames"] if isinstance(mix["frames"], list) else [
        mix["frames"]]
    hole = mix["hole"]
    shape = common.load_module("holes", hole["kind"]).masks
    rng = np.random.RandomState(seed % 2 ** 32)
    masks = [shape(hole, i, lengths[i % len(lengths)], h, w, pan)
             for i in range(mix["pool"])]
    return [(panning_background(rng, m.shape[0], h, w, pan), m)
            for m in masks]
