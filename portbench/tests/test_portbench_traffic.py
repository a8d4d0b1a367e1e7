"""Each traffic generator is deterministic in the seed; the stroke
pools' hole shares."""

import numpy as np
import pytest
import torch

from portbench import traffic


@pytest.mark.parametrize("mix", ["removal_square_24f", "removal_strokes_24f"])
def test_removal_clips_deterministic(mix):
    m = traffic.load_mix(mix)
    a, b = (traffic.make(m, 2 ** 31 + 17) for _ in range(2))
    c = traffic.make(m, 5)
    for (fa, ma), (fb, mb) in zip(a, b):
        assert np.array_equal(fa, fb) and np.array_equal(ma, mb)
    assert not np.array_equal(a[0][0], c[0][0])
    share = float(np.mean([mk.mean() for _, mk in a]))
    print(f"{mix}: {len(a)} clips, hole share {share:.4f}")
    assert a[0][0].shape == (24, 240, 432, 3)
    assert a[0][1].shape == (24, 240, 432)


def test_stroke_holes_are_the_same_for_every_seed():
    m = traffic.load_mix("removal_strokes_24f")
    a, b = (traffic.make(m, s) for s in (1, 2))
    for (fa, ma), (fb, mb) in zip(a, b):
        assert np.array_equal(ma, mb) and not np.array_equal(fa, fb)


def test_train_batches_deterministic():
    m = traffic.load_mix("train_strokes_b2")
    m = dict(m, height=48, width=64)
    a, b = (traffic.make(m, 3 * 2 ** 31, "cpu") for _ in range(2))
    for _ in range(2):
        x, y = a.next(), b.next()
        for k in x:
            assert torch.equal(x[k], y[k])
    assert x["frames"].shape == (2, 5, 48, 64, 3)
    assert x["frames"].min() >= -1 and x["frames"].max() <= 1
    assert set(np.unique(x["masks"].numpy())) <= {0.0, 1.0}
    share = float(a.masks.mean())
    print(f"train_strokes_b2 at 48x64: hole share {share:.4f}")
    assert not torch.equal(a.next()["flows"], x["flows"])


def test_clip_lengths_and_hole_kinds_come_from_the_mix():
    m = {"kind": "removal_clips", "frames": [5, 9, 7], "height": 32,
         "width": 40, "pan_px": 2, "pool": 4,
         "hole": {"kind": "strokes", "mask_seeds": [3, 4], "n_stroke": 2,
                  "brush": [3, 6]}}
    clips = traffic.make(m, 11)
    assert [f.shape[0] for f, _ in clips] == [5, 9, 7, 5]
    assert all(mk.shape == f.shape[:3] for f, mk in clips)
    assert np.array_equal(clips[0][1], traffic.stroke_masks(
        5, 32, 40, 3, n_stroke=2, brush=(3, 6)))
    square = dict(m, frames=6, hole={"kind": "square", "size": 8, "y0": 4,
                                     "x0": 4})
    got = traffic.make(square, 11)
    assert all(np.array_equal(mk, got[0][1]) for _, mk in got)
    assert got[0][1].sum() == 6 * 8 * 8
