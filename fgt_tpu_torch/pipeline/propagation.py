"""Flow-guided gradient propagation (flowNN), stage s4 — the port's own
copy of the frame-first native path of ``fgt_tpu/pipeline/propagation.py``
(``get_flownn_gradient_frames``; reference tool/get_flowNN_gradient.py).

1. Two chaining passes (forward along backward flows, backward along
   forward flows) find, for every hole pixel, a chain endpoint in a frame
   where the pixel is known, gated by forward/backward cycle consistency.
2. Gradients are sampled at the chain endpoints, in chain order, so
   transitively filled values feed later frames.
3. The two candidates are fused with weights exp(-consistency/alpha);
   pixels with no candidate come back as the still-unfilled mask.

All three steps run in the OpenMP kernels of ``native/fgt_native.cpp``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fgt_tpu_torch import native


@dataclasses.dataclass
class PropagationConfig:
    consistency_thres: float = 5.0
    alpha: float = 0.1


def get_flownn_gradient_frames(cfg: PropagationConfig,
                               gradient_x: np.ndarray,
                               gradient_y: np.ndarray, mask: np.ndarray,
                               video_flow_f: np.ndarray,
                               video_flow_b: np.ndarray):
    """gradient_x/y: [N, H, W, C]; mask: [N, H, W] bool; video_flow_f/b:
    [N-1, H, W, 2]. CONSUMES contiguous f32 gradients (filled in place).

    Returns (gradient_x, gradient_y, mask_tofill), frame-first."""
    mask_n = np.ascontiguousarray(mask, np.uint8)
    vf = np.ascontiguousarray(video_flow_f, np.float32)
    vb = np.ascontiguousarray(video_flow_b, np.float32)
    bn_pass = native.flownn_pass(mask_n, vb, vf, True, cfg.consistency_thres)
    fn_pass = native.flownn_pass(mask_n, vf, vb, False, cfg.consistency_thres)

    gx = np.ascontiguousarray(gradient_x, np.float32)
    gy = np.ascontiguousarray(gradient_y, np.float32)
    # one chain walk per direction over its own evolving copy (gx|gy
    # stacked on channels), sampled in place
    s_bn = np.concatenate([gx, gy], axis=3)
    s_fn = np.concatenate([gx, gy], axis=3)
    native.flownn_sample(s_bn, *bn_pass[:4], True)
    native.flownn_sample(s_fn, *fn_pass[:4], False)
    tofill = native.flownn_fuse(gx, gy, s_bn, s_fn, bn_pass, fn_pass, mask_n,
                                cfg.alpha)
    return gx, gy, tofill.view(bool)
