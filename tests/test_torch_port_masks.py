"""The port's hole masks and host regionfill against cv2 and the JAX
package, on the CPU:

* ``core/raster.py``'s twins bit-equal to cv2: ``fill_poly`` on seeded
  bezier blobs (the mask generator's own polygons at 256x256) and on
  random, self-intersecting polygons; ``fill_ellipse`` on the
  generator's fallback ellipse and random ones; ``rotation_matrix_2d``
  and ``warp_affine_nearest`` on random masks, angles 1-10 and odd
  widths;
* ``core/masks.create_random_shape_with_random_motion`` equal to the JAX
  generator mask for mask over 60 seeds at 240x432 and at 256x256, and
  the smaller helpers equal;
* ``core/region_fill`` equal to the JAX package's: the same sparse
  system through the same scipy ``spsolve``, so bit-equal.
"""

import random

import cv2
import numpy as np
import pytest

from fgt_tpu.core import masks as jmasks
from fgt_tpu.core import region_fill as jfill
from fgt_tpu_torch.core import masks as tmasks
from fgt_tpu_torch.core import raster
from fgt_tpu_torch.core import region_fill as tfill


def _bezier_polygon(rng):
    edge_num, ratio = rng.randint(6, 9), rng.randint(6, 9) / 10
    n = edge_num * 3 + 1
    angles = np.linspace(0, 2 * np.pi, n)
    radii = 2 * ratio * rng.random_sample(n) + 1 - ratio
    verts = np.stack((np.cos(angles), np.sin(angles)), 1) * radii[:, None]
    verts[-1] = verts[0]
    path = tmasks._sample_bezier_path(verts)
    lo, hi = path.min(0), path.max(0)
    return ((path - lo) / np.maximum(hi - lo, 1e-6) * 255).astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_fill_poly_bit_equal_on_bezier_blobs(seed):
    rng = np.random.RandomState(seed)
    for _ in range(40):
        poly = _bezier_polygon(rng)
        want = cv2.fillPoly(np.zeros((256, 256), np.uint8), [poly], 255)
        got = raster.fill_poly(np.zeros((256, 256), np.uint8), poly, 255)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_fill_poly_bit_equal_on_random_polygons(seed):
    rng = np.random.RandomState(100 + seed)
    for _ in range(80):
        n = rng.randint(3, 14)
        h, w = rng.randint(4, 90, 2)
        poly = np.stack([rng.randint(0, w, n), rng.randint(0, h, n)],
                        1).astype(np.int32)
        want = cv2.fillPoly(np.zeros((h, w), np.uint8), [poly], 255)
        got = raster.fill_poly(np.zeros((h, w), np.uint8), poly, 255)
        assert np.array_equal(got, want), poly.tolist()


def test_fill_ellipse_bit_equal():
    rng = np.random.RandomState(0)
    cases = [((w // 2, h // 2), (w // 3, h // 3), h, w)
             for h, w in ((240, 432), (256, 256), (80, 144), (12, 20),
                          (9, 9), (3, 5))]
    for _ in range(60):
        h, w = rng.randint(4, 300, 2)
        cases.append(((int(rng.randint(w // 4, 3 * w // 4 + 1)),
                       int(rng.randint(h // 4, 3 * h // 4 + 1))),
                      (int(rng.randint(0, w // 4 + 1)),
                       int(rng.randint(0, h // 4 + 1))), h, w))
    for center, axes, h, w in cases:
        want = cv2.ellipse(np.zeros((h, w), np.uint8), center, axes, 0, 0,
                           360, 255, -1)
        got = raster.fill_ellipse(np.zeros((h, w), np.uint8), center, axes)
        assert np.array_equal(got, want), (center, axes, h, w)


@pytest.mark.parametrize("size", [(240, 432), (256, 256), (251, 437),
                                  (100, 23)])
def test_rotation_and_nearest_warp_bit_equal(size):
    h, w = size
    rng = np.random.RandomState(h + w)
    for _ in range(15):
        m = (rng.rand(h, w) > 0.5).astype(np.uint8) * 255
        angle = int(rng.randint(1, 11))
        want_m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        got_m = raster.rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
        assert np.array_equal(got_m, want_m)
        want = cv2.warpAffine(m, want_m, (w, h), flags=cv2.INTER_NEAREST)
        assert np.array_equal(raster.warp_affine_nearest(m, got_m, w, h),
                              want)


@pytest.mark.parametrize("size", [(240, 432), (256, 256)])
def test_moving_masks_equal_jax_over_seeds(size):
    """60 seeds: every frame's mask equal, static and moving clips, zooms
    and rotations among them."""
    h, w = size
    for seed in range(60):
        got_want = []
        for mod in (tmasks, jmasks):
            random.seed(seed)
            np.random.seed(seed)
            got_want.append(mod.create_random_shape_with_random_motion(
                5, 0.9, 1.1, 1, 10, imageHeight=h, imageWidth=w))
            got_want.append(np.random.random())     # the draws line up
        got, g_next, want, w_next = got_want
        assert len(got) == len(want) and g_next == w_next
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), seed


def test_mask_helpers_equal_jax():
    for seed in range(5):
        np.random.seed(seed)
        want = jmasks.get_random_shape(7, 0.7, width=150, height=90)
        np.random.seed(seed)
        assert np.array_equal(tmasks.get_random_shape(7, 0.7, width=150,
                                                      height=90), want)
        got = tmasks.bbox_mask(60, 80, np.random.RandomState(seed))
        assert np.array_equal(got, jmasks.bbox_mask(
            60, 80, np.random.RandomState(seed)))
        assert tmasks.get_masked_ratio(got) == jmasks.get_masked_ratio(got)
    assert np.array_equal(tmasks.rect_mask(240, 432, 96),
                          jmasks.rect_mask(240, 432, 96))


@pytest.mark.parametrize("seed", range(3))
def test_regionfill_equal_jax(seed):
    rng = np.random.RandomState(seed)
    random.seed(seed)
    np.random.seed(seed)
    h, w = 40, 56
    masks = tmasks.create_random_shape_with_random_motion(
        1, imageHeight=h, imageWidth=w) if seed else \
        [np.pad(np.full((10, 12), 255, np.uint8), ((0, 30), (0, 44)))]
    mask = (masks[0] > 0).astype(np.uint8)
    flow = rng.randn(h, w, 2).astype(np.float32) * 4
    img = flow[..., 0].astype(np.float64)
    assert np.array_equal(tfill.regionfill(img, mask),
                          jfill.regionfill(img, mask))
    assert np.array_equal(tfill.diffuse_flow(flow, mask),
                          jfill.diffuse_flow(flow, mask))
    assert np.array_equal(tfill._find_boundary(mask > 0),
                          jfill._find_boundary(mask > 0))
    with pytest.raises(NotImplementedError):
        tfill.regionfill(img, mask, factor=0.5)
