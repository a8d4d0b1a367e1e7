"""VFID (video Fréchet Inception Distance) with an I3D feature trunk — the
port's counterpart of ``fgt_tpu/core/vfid.py``.

* :class:`I3D` — the `pytorch-i3d` ``InceptionI3d`` feature trunk up to
  Mixed_5c, globally pooled to [B, 1024]. Parameter names are
  pytorch-i3d's (``Conv3d_1a_7x7.conv3d.weight``,
  ``Mixed_3b.b1a.bn.running_mean``, ...), so its ``rgb_imagenet.pt``
  loads through :func:`load_i3d_state` (which drops the classifier
  ``logits.*`` and ``num_batches_tracked``). Padding is the JAX module's,
  ``((k-1)//2, k//2)`` per dimension, zeros before a convolution and
  −inf before a max pool, as flax pads them; batch norm is frozen
  (running statistics, eps 1e-3).
* :class:`VFIDScorer` / :func:`vfid` — I3D features of (real, fake)
  clips on the device, statistics and the distance on the host as the
  JAX scorer takes them (numpy / scipy: the float32 features' mean, their
  float64 covariance, the distance in float64), with its clip cut: clips of
  ``clip_len`` frames from the start, a tail clip ending at the last
  frame, short videos tiled.

The scorer runs I3D in float32 with TF32 off (``F32_PRECISION``), so a
card and the CPU compute the same function.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.ops.conv_blocks import FrozenBatchNorm

F32_PRECISION = "float32, TF32 off"
INCEPTION_BLOCKS = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)
STEM = (("Conv3d_1a_7x7", 3, 64, (7, 7, 7), (2, 2, 2)),
        ("Conv3d_2b_1x1", 64, 64, (1, 1, 1), (1, 1, 1)),
        ("Conv3d_2c_3x3", 64, 192, (3, 3, 3), (1, 1, 1)))
BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")


def _same_pads(kernel: Sequence[int]) -> list:
    """F.pad's order (W, H, T), each ((k-1)//2, k//2)."""
    pads = []
    for k in reversed(kernel):
        pads += [(k - 1) // 2, k // 2]
    return pads


class Unit3D(nn.Module):
    """Conv3d (no bias) + frozen BN + ReLU, zero-padded ((k-1)//2, k//2)."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1)):
        super().__init__()
        self.pads = _same_pads(kernel)
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride=stride, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv3d(F.pad(x, self.pads))))


def max_pool3d(x, kernel, stride):
    """flax ``max_pool`` with ((k-1)//2, k//2) padding: −inf pads."""
    return F.max_pool3d(F.pad(x, _same_pads(kernel), value=float("-inf")),
                        kernel, stride)


class InceptionBlock(nn.Module):
    """Mixed block: 1x1 | 1x1 -> 3x3 | 1x1 -> 3x3 | pool -> 1x1."""

    def __init__(self, cin: int, out: Sequence[int]):
        super().__init__()
        self.b0 = Unit3D(cin, out[0])
        self.b1a = Unit3D(cin, out[1])
        self.b1b = Unit3D(out[1], out[2], (3, 3, 3))
        self.b2a = Unit3D(cin, out[3])
        self.b2b = Unit3D(out[3], out[4], (3, 3, 3))
        self.b3b = Unit3D(cin, out[5])

    def forward(self, x):
        return torch.cat([
            self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
            self.b3b(max_pool3d(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class I3D(nn.Module):
    """InceptionI3d feature trunk. Input [B, T, H, W, 3] in [-1, 1]
    (T >= 9, any spatial size >= 32); output [B, 1024] Mixed_5c features
    averaged over time and space."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s in STEM:
            setattr(self, name, Unit3D(cin, cout, k, s))
        cin = 192
        for name, out in INCEPTION_BLOCKS:
            setattr(self, name, InceptionBlock(cin, out))
            cin = out[0] + out[2] + out[4] + out[5]

    def forward(self, video):
        x = video.permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool3d(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool3d(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        return x.mean(dim=(2, 3, 4))


def init_i3d(model: I3D, gen: torch.Generator) -> I3D:
    """Seeded random init: LeCun-normal convolutions (flax's default),
    identity batch norms."""
    for m in model.modules():
        if isinstance(m, nn.Conv3d):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * (1.0 / fan_in) ** 0.5)
    return model


def load_i3d_state(model: I3D, state: dict) -> I3D:
    """Strict load of a pytorch-i3d ``InceptionI3d`` state dict, without
    its classifier (``logits.*``) and BN ``num_batches_tracked``."""
    keep = {k: v for k, v in state.items()
            if not k.startswith("logits.")
            and not k.endswith("num_batches_tracked")}
    model.load_state_dict({k: torch.as_tensor(v) for k, v in keep.items()})
    return model


@contextlib.contextmanager
def f32_precision():
    """Convolutions and matmuls in full float32 (no TF32) inside."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


# ---------------- the statistic ----------------

def feature_stats(features: np.ndarray):
    mu = features.mean(axis=0)
    cov = np.cov(features, rowvar=False)
    return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(c1 + c2 - 2 sqrt(c1 c2))."""
    import scipy.linalg

    diff = mu1 - mu2
    # sqrtm's value without the deprecated ``disp=False`` (SciPy 1.18
    # removes it): the JAX package's call returns the same matrix
    covmean = scipy.linalg.sqrtm(cov1.dot(cov2))
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm(
            (cov1 + offset).dot(cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(covmean))


class VFIDScorer:
    """Accumulates I3D features of (real, fake) clip pairs, then scores.
    ``state``: a pytorch-i3d state dict (random init from ``seed`` when
    None). Features are computed on ``device`` in float32 without TF32."""

    def __init__(self, state: Optional[dict] = None, clip_len: int = 16,
                 device: str = DEFAULT_DEVICE, seed: int = 0):
        self.device = torch.device(device)
        self.clip_len = clip_len
        model = I3D()
        if state is None:
            init_i3d(model, torch.Generator().manual_seed(seed))
        else:
            load_i3d_state(model, state)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.real: list = []
        self.fake: list = []

    def clips(self, video: np.ndarray) -> np.ndarray:
        """[T, H, W, 3] uint8/float in [0, 255] -> [n, clip_len, H, W, 3]
        f32 clips in [-1, 1] (short videos tiled)."""
        v = np.asarray(video, np.float32) / 127.5 - 1.0
        t = v.shape[0]
        starts = list(range(0, max(t - self.clip_len + 1, 1), self.clip_len))
        # a tail clip ending at the last frame where the clips miss it
        if t > self.clip_len and starts[-1] + self.clip_len < t:
            starts.append(t - self.clip_len)
        out = []
        for s in starts:
            clip = v[s:s + self.clip_len]
            if clip.shape[0] < self.clip_len:
                reps = -(-self.clip_len // clip.shape[0])
                clip = np.concatenate([clip] * reps, 0)[:self.clip_len]
            out.append(clip)
        return np.stack(out)

    def features(self, video: np.ndarray) -> np.ndarray:
        clips = torch.from_numpy(self.clips(video)).to(self.device)
        with torch.inference_mode(), f32_precision():
            return self.model(clips).float().cpu().numpy()

    def update(self, real_video: np.ndarray, fake_video: np.ndarray):
        self.real.append(self.features(real_video))
        self.fake.append(self.features(fake_video))

    def score(self) -> float:
        real = np.concatenate(self.real, 0)
        fake = np.concatenate(self.fake, 0)
        return frechet_distance(*feature_stats(real), *feature_stats(fake))


def vfid(real_videos, fake_videos, state: Optional[dict] = None,
         device: str = DEFAULT_DEVICE) -> float:
    scorer = VFIDScorer(state, device=device)
    for r, f in zip(real_videos, fake_videos):
        scorer.update(r, f)
    return scorer.score()
