"""The port's dataset-preparation masks against the JAX package and cv2,
on the CPU:

* ``fgt_tpu_torch.data.mask_models`` — the five mask models and the
  helpers, bit-equal to ``fgt_tpu.data.mask_models`` for several seeds,
  sizes and ``dataInfo`` blocks; ``core.masks``'s moving-stroke
  generator bit-equal to the JAX one; neither touches the global
  ``random`` / ``np.random`` state;
* ``core.raster.thick_line`` / ``circle_filled`` bit-equal to
  ``cv2.line`` / ``cv2.circle(..., -1)`` over thicknesses 2-25 (odd and
  even) and radii 0-30, ends inside, on and past the border, zero-length
  lines, uint8 and float32 images;
* ``core.raster.external_bboxes`` equal to ``cv2.findContours(
  RETR_EXTERNAL, CHAIN_APPROX_NONE)`` + ``cv2.boundingRect``, in order,
  on random, nested, diagonal-touching and border components.
"""

import random

import cv2
import numpy as np
import pytest

from fgt_tpu.core import masks as jmasks
from fgt_tpu.data import mask_models as jmm
from fgt_tpu_torch.core import masks as tmasks
from fgt_tpu_torch.core import raster
from fgt_tpu_torch.data import mask_models as tmm

SIZES = [(240, 432), (64, 96), (37, 53)]


def _info(h, w, **mask):
    base = {"mask_height": h // 3, "mask_width": w // 3,
            "max_delta_height": 8, "max_delta_width": 8,
            "vertical_margin": 4, "horizontal_margin": 4}
    base.update(mask)
    return {"image": {"image_height": h, "image_width": w}, "mask": base}


def _global_state():
    return random.getstate(), np.random.get_state()


def _same_state(a, b):
    return a[0] == b[0] and all(
        np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("name", sorted(jmm.MASK_MODELS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mask_models_bit_equal_to_jax(name, size):
    h, w = size
    infos = [_info(h, w), _info(h, w, row=3, column=2, max_vertex=6,
                                max_length=30, max_brush_width=14,
                                max_angle=np.pi)]
    random.seed(5)
    np.random.seed(5)
    before = _global_state()
    for info in infos:
        for seed in (0, 1, 7, 123):
            want = jmm.build_mask_model(name, 5, info, seed=seed)()
            got = tmm.build_mask_model(name, 5, info, seed=seed)()
            assert got.dtype == np.float32 and got.shape == (5, h, w, 1)
            assert set(np.unique(got)) <= {0.0, 255.0}
            np.testing.assert_array_equal(got, want, err_msg=str(seed))
    assert _same_state(before, _global_state())


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moving_strokes_bit_equal_to_jax(size):
    h, w = size
    random.seed(3)
    np.random.seed(3)
    before = _global_state()
    for seed in (0, 1, 2, 99):
        for kw in ({}, {"nStroke": 2, "brushWidthBound": (2, 25),
                        "boarderGap": 8, "maxPiontMove": 20}):
            want = jmasks.get_video_masks_by_moving_random_stroke(
                6, w, h, seed=seed, **kw)
            got = tmasks.get_video_masks_by_moving_random_stroke(
                6, w, h, seed=seed, **kw)
            assert len(got) == 6
            for a, b in zip(got, want):
                assert a.dtype == np.uint8 and a.shape == (h, w)
                np.testing.assert_array_equal(a, b, err_msg=str(seed))
    assert _same_state(before, _global_state())


def test_mask_helpers_bit_equal_to_jax():
    for seed in range(6):
        rj, rt = np.random.RandomState(seed), np.random.RandomState(seed)
        assert jmm.random_bbox(60, 80, 3, 4, 20, 30, rng=rj) == \
            tmm.random_bbox(60, 80, 3, 4, 20, 30, rng=rt)
        bbox = (5, 7, 20, 30)
        np.testing.assert_array_equal(
            jmm.bbox2mask(60, 80, 6, 8, bbox, rng=rj),
            tmm.bbox2mask(60, 80, 6, 8, bbox, rng=rt))
        np.testing.assert_array_equal(
            jmm.free_form_mask(50, 70, rng=rj),
            tmm.free_form_mask(50, 70, rng=rt))
    np.testing.assert_array_equal(jmm.mid_bbox_mask(48, 64, 10, 12),
                                  tmm.mid_bbox_mask(48, 64, 10, 12))
    assert jmm.matrix2bbox(90, 120, 20, 50, 3, 2) == \
        tmm.matrix2bbox(90, 120, 20, 50, 3, 2)
    assert sorted(tmm.MASK_MODELS) == sorted(jmm.MASK_MODELS)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("thickness", range(2, 26))
def test_thick_line_bit_equal_to_cv2(thickness, dtype):
    """Ends inside, on and past every border (cv2 clips the segment to
    the image grown by the thickness first), and zero-length lines."""
    rng = np.random.RandomState(thickness)
    for it in range(60):
        h, w = rng.randint(5, 90, 2)

        def point():
            if it % 3 == 0:     # on the border
                return (int(rng.choice([0, w - 1, w])),
                        int(rng.randint(0, h + 1)))
            return (int(rng.randint(-40, w + 40)),
                    int(rng.randint(-40, h + 40)))

        p0 = point()
        p1 = p0 if it % 10 == 0 else point()
        want = cv2.line(np.zeros((h, w), dtype), p0, p1, 255, thickness)
        got = raster.thick_line(np.zeros((h, w), dtype), p0, p1, 255,
                                thickness)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, p0, p1)))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_circle_filled_bit_equal_to_cv2(dtype):
    rng = np.random.RandomState(0)
    for radius in range(31):
        for _ in range(12):
            h, w = rng.randint(3, 70, 2)
            c = (int(rng.randint(-35, w + 35)), int(rng.randint(-35, h + 35)))
            want = cv2.circle(np.zeros((h, w), dtype), c, radius, 255, -1)
            got = raster.circle_filled(np.zeros((h, w), dtype), c, radius,
                                       255)
            np.testing.assert_array_equal(got, want, err_msg=str((c, radius)))


def _cv2_boxes(mask):
    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_NONE)
    return [cv2.boundingRect(c) for c in contours]


@pytest.mark.parametrize("seed", range(4))
def test_external_bboxes_equal_cv2_in_order(seed):
    rng = np.random.RandomState(seed)
    for it in range(120):
        h, w = rng.randint(2, 70, 2)
        m = rng.rand(h, w) < rng.uniform(0.02, 0.7)
        if it % 3 == 1:          # rings: components nested in holes
            m = cv2.dilate(m.astype(np.uint8), np.ones((3, 3), np.uint8)
                           ).astype(bool) ^ m
        assert [tuple(b) for b in raster.external_bboxes(m)] == \
            _cv2_boxes(m), (h, w)


def test_external_bboxes_nested_diagonal_and_border():
    m = np.zeros((40, 50), bool)
    m[2:20, 2:20] = True
    m[5:17, 5:17] = False        # a hole ...
    m[8:12, 8:12] = True         # ... holding a component: left out
    m[30, 30] = m[31, 31] = True           # diagonal neighbours: one
    m[31, 30] = False
    m[0, 45:50] = True           # on the border
    m[35:40, 0] = True
    m[25, 40] = m[26, 41] = m[27, 40] = True   # a diagonal chain
    got = [tuple(b) for b in raster.external_bboxes(m)]
    assert got == _cv2_boxes(m)
    assert (8, 8, 4, 4) not in got and (30, 30, 2, 2) in got
    assert raster.external_bboxes(np.zeros((4, 4), bool)) == []
