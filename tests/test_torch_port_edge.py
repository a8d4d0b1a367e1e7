"""The port's cv2-free Canny (``fgt_tpu_torch/core/edge.py``) against the
JAX package's cv2 one (``fgt_tpu/core/edge.py``), on the CPU:

* the uint8 gray conversion is bit-equal to ``cv2.cvtColor(RGB2GRAY)``
  over every RGB colour;
* the Gaussian kernel, the blur and the Sobel gradients are bit-equal
  to ``cv2.getGaussianKernel``, ``cv2.GaussianBlur`` and ``cv2.Sobel``
  (ragged widths included, where cv2's vector loop leaves a tail);
* ``canny`` and ``flow_edge`` give the same edge maps (and gray
  magnitudes) on seeded flows of moving blocks over a smooth field,
  strong noise or faint noise, at 64x64 and 256x256, and ``canny``
  the same map under a mask.
"""

import cv2
import numpy as np
import pytest
import scipy.ndimage

from fgt_tpu.core import edge as jedge
from fgt_tpu_torch.core import edge as tedge


def _flow(kind, size, seed):
    """Moving blocks (the motion boundaries Canny finds) over a smooth
    field, over strong noise, or over faint noise."""
    rng = np.random.RandomState(seed)
    flow = np.zeros((size, size, 2), np.float32)
    for _ in range(4):
        y, x = rng.randint(0, size - size // 4, 2)
        flow[y:y + size // 4, x:x + size // 3] = rng.uniform(-8, 8, 2)
    if kind == "smooth":
        field = scipy.ndimage.gaussian_filter(
            rng.randn(size, size, 2), sigma=(size / 12, size / 12, 0))
        return flow + (field / np.abs(field).max() * 3).astype(np.float32)
    noise = 0.5 if kind == "noisy" else 0.05
    return flow + rng.randn(size, size, 2).astype(np.float32) * noise


def test_gray_u8_is_bit_equal_to_cv2_over_every_colour():
    v = np.arange(256, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(
        4096, 4096, 3)
    np.testing.assert_array_equal(tedge.rgb_to_gray_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("n,sigma", [(3, 0.5), (5, 1.0), (9, 2.0)])
def test_gaussian_kernel_is_bit_equal_to_cv2(n, sigma):
    np.testing.assert_array_equal(
        tedge.gaussian_kernel(n, sigma),
        cv2.getGaussianKernel(n, sigma, cv2.CV_64F)[:, 0])


@pytest.mark.parametrize("h,w", [(64, 64), (37, 67), (256, 256), (9, 5)])
def test_blur_and_sobel_are_bit_equal_to_cv2(h, w):
    img = np.random.RandomState(h * w).rand(h, w)
    blurred = tedge._blur(img, 1.0)
    np.testing.assert_array_equal(blurred,
                                  cv2.GaussianBlur(img, (5, 5), 1.0))
    gx, gy = tedge._sobel(blurred)
    np.testing.assert_array_equal(
        gx, cv2.Sobel(blurred, cv2.CV_64F, 1, 0, ksize=3))
    np.testing.assert_array_equal(
        gy, cv2.Sobel(blurred, cv2.CV_64F, 0, 1, ksize=3))


@pytest.mark.parametrize("size", [64, 256])
@pytest.mark.parametrize("kind", ["smooth", "noisy", "faint"])
@pytest.mark.parametrize("seed", [0, 1])
def test_flow_edge_matches_jax(kind, size, seed):
    """The same edges, bit for bit, and the same gray magnitude; the
    edge maps are neither empty nor full."""
    flow = _flow(kind, size, seed)
    want_gray, want = jedge.flow_edge(flow)
    got_gray, got = tedge.flow_edge(flow)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_gray, want_gray)
    assert 0 < want.sum() < want.size


def test_canny_with_mask_and_thresholds_matches_jax():
    rng = np.random.RandomState(3)
    img = scipy.ndimage.gaussian_filter(rng.rand(96, 80), 2)
    img = (img - img.min()) / (img.max() - img.min())
    mask = rng.rand(96, 80) > 0.3
    for kw in ({}, {"sigma": 2.0, "low_threshold": 0.02,
                    "high_threshold": 0.05}):
        np.testing.assert_array_equal(tedge.canny(img, mask=mask, **kw),
                                      jedge.canny(img, mask=mask, **kw))
    empty = np.zeros((16, 16))
    assert not tedge.canny(empty).any() and not jedge.canny(empty).any()
