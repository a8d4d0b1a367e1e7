"""The JAX pipeline seeds holes with cv2's TELEA inpainting before taking
gradients (``prepare_gradients``) and again for pixels Poisson leaves
unfilled. The port seeds nothing. This pins why that is safe: with
``cv2.inpaint`` replaced by a constant fill, the JAX pipeline's output is
byte-identical — gradient_mask zeroes every difference touching a hole
pixel, Poisson solves the hole directly, and pixels left for FGT are
masked out of its input and replaced in the composite. The same holds
for video extrapolation, where TELEA also fills the whole canvas
border before the gradients are taken."""

import cv2
import numpy as np

from test_torch_port_pipeline import _video, run_jax_pipeline


def test_telea_fill_never_reaches_the_jax_result(tmp_path, monkeypatch):
    frames, masks = _video(6, 64, 64, seed=5)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want, _ = run_jax_pipeline(tmp_path / "a", frames, masks)
    calls = []

    def constant_fill(img, mask, radius, flags):
        calls.append(int(mask.sum()))
        out = img.copy()
        out[mask > 0] = 77
        return out

    monkeypatch.setattr(cv2, "inpaint", constant_fill)
    got, _ = run_jax_pipeline(tmp_path / "b", frames, masks)
    assert len(calls) >= 6 and sum(calls) > 0   # the seed really ran
    np.testing.assert_array_equal(got, want)


def test_telea_fill_never_reaches_the_jax_extrapolation(tmp_path,
                                                        monkeypatch):
    """Video extrapolation to a 1.2x canvas: real TELEA against a
    constant fill, byte-identical output."""
    frames, masks = _video(6, 64, 64, seed=5)
    extra = ("--mode", "video_extrapolation", "--H_scale", "1.2",
             "--W_scale", "1.2")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want, _ = run_jax_pipeline(tmp_path / "a", frames, masks, extra=extra)
    calls = []

    def constant_fill(img, mask, radius, flags):
        calls.append(int(mask.sum()))
        out = img.copy()
        out[mask > 0] = 77
        return out

    monkeypatch.setattr(cv2, "inpaint", constant_fill)
    got, _ = run_jax_pipeline(tmp_path / "b", frames, masks, extra=extra)
    assert want.shape == (6, 76, 76, 3)
    assert len(calls) >= 12 and sum(calls) > 0   # canvas and gradient seeds
    np.testing.assert_array_equal(got, want)
