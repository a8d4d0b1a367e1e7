"""The FVI moving-stroke holes (:func:`portbench.traffic.stroke_masks`):
clip ``i`` of the pool takes mask seed ``mask_seeds[i % len]``, so every
run seed sends the same holes in the same order; the other keys are the
generator's parameters."""

from portbench.traffic import stroke_kw, stroke_masks


def masks(hole: dict, i: int, n: int, h: int, w: int, pan: int):
    seeds = hole["mask_seeds"]
    return stroke_masks(n, h, w, seeds[i % len(seeds)], **stroke_kw(hole))
