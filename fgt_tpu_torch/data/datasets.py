"""Training datasets — counterpart of ``fgt_tpu/data/datasets.py``:
pure numpy, channel-last, no cv2 or imageio.

* ``FGTVideoDataset`` — FGT/data/train_dataset.py:19-164 (5-frame
  samples, STTN moving masks, .flo reads with resize and rescale,
  regionfill diffusion, frames normalized to [-1, 1]);
* ``LAFCFlowDataset`` — LAFC/data/train_dataset_edge.py:20-173 (random
  forward/backward direction, ``num_flows`` flows at ``flow_interval``
  around a pivot, the pivot frame pair for the census loss, the Canny
  edge of the pivot flow);
* ``LAFCSingleFlowDataset`` — LAFC/data/train_dataset_single_edge.py.

Items are numpy dicts of [T, H, W, C] / [H, W, C] arrays under the JAX
datasets' keys, drawn from ``random`` and ``np.random`` in their order,
so the same seeds give equal items. Frames are JPEG or PNG, read as the
JAX datasets' imageio reads them (EXIF orientation ignored), resized as
cv2 resizes uint8
(``image_io.resize_linear_u8``); masks by ``resize_nearest``, flows by
``resize_linear``, both bit-equal to cv2. A failed item is replaced by
item 0, as the reference does (train_dataset.py:39-45).
"""

from __future__ import annotations

import logging
import os
import pickle
import random

import numpy as np

from fgt_tpu_torch.core.edge import flow_edge
from fgt_tpu_torch.core.flow_io import read_flow
from fgt_tpu_torch.core.masks import create_random_shape_with_random_motion
from fgt_tpu_torch.core.region_fill import regionfill
from fgt_tpu_torch.pipeline import image_io

logger = logging.getLogger("fgt_tpu_torch.data")


def load_name2len(path_or_dir, frame_root: str | None = None) -> dict:
    """Video -> frame-count index: the reference's pickle
    (FGT/data/train_dataset.py:29-31), or built by listing the frame
    directories."""
    if path_or_dir and os.path.isfile(path_or_dir):
        with open(path_or_dir, "rb") as f:
            return pickle.load(f)
    root = frame_root if frame_root else path_or_dir
    out = {}
    for v in sorted(os.listdir(root)):
        d = os.path.join(root, v)
        if os.path.isdir(d):
            out[v] = len([f for f in os.listdir(d)
                          if f.endswith((".jpg", ".png"))])
    return out


def read_frame(path: str, height: int, width: int) -> np.ndarray:
    """[height, width, 3] uint8 RGB of a JPEG or PNG frame."""
    frame = image_io.imread(path, "unchanged")
    if frame.ndim == 2:
        frame = np.stack([frame] * 3, axis=-1)
    return image_io.resize_linear_u8(frame[..., :3], height, width)


def resize_mask(mask: np.ndarray, height: int, width: int) -> np.ndarray:
    """255-valued uint8 mask -> {0, 1} uint8 at (height, width)
    (reference read_mask, train_dataset.py:115-120)."""
    raw = (np.asarray(mask) / 255.0 > 0.5).astype(np.uint8)
    return image_io.resize_nearest(raw[None], height, width)[0]


def flow_tf(flow: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize a flow field and rescale its vectors
    (reference flow_tf / read_forward_flow, train_dataset.py:121-128)."""
    h, w = flow.shape[:2]
    out = image_io.resize_linear(flow[None], height, width)[0]
    out[:, :, 0] *= float(width) / float(w)
    out[:, :, 1] *= float(height) / float(h)
    return out


def diffusion_fill(flow: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Laplacian regionfill of both channels with the hole zeroed first
    (reference diffusion_flow, train_dataset.py:103-107); float64."""
    out = np.zeros(flow.shape, dtype=np.float64)
    out[:, :, 0] = regionfill(flow[:, :, 0] * (1 - mask), mask)
    out[:, :, 1] = regionfill(flow[:, :, 1] * (1 - mask), mask)
    return out


def _frame_file(frame_dir: str, idx: int) -> str:
    """The reference's ``05d.jpg``, or the ``.png`` beside it."""
    p = os.path.join(frame_dir, f"{idx:05d}.jpg")
    if not os.path.exists(p):
        alt = os.path.join(frame_dir, f"{idx:05d}.png")
        if os.path.exists(alt):
            return alt
    return p


class _VideoListDataset:
    """A sorted list of video directories; a failed item is replaced by
    item 0, whose own failure propagates."""

    def __init__(self, list_root: str):
        self.train_list = sorted(os.listdir(list_root))

    def __len__(self) -> int:
        return len(self.train_list)

    def __getitem__(self, idx: int) -> dict:
        try:
            return self.load_item(idx)
        except Exception:  # noqa: BLE001 — the reference catches everything
            logger.warning("Loading error: %s", self.train_list[idx],
                           exc_info=True)
            return self.load_item(0)

    def load_item(self, idx: int) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError


class FGTVideoDataset(_VideoListDataset):
    """5-frame video samples with synthesized masks and diffused
    flows."""

    def __init__(self, opt: dict, data_info: dict):
        super().__init__(data_info["frame_path"])
        self.opt = opt
        self.sample_method = opt.get("sample", "random")
        self.height, self.width = opt["input_resolution"]
        self.frame_path = data_info["frame_path"]
        self.flow_path = data_info["flow_path"]
        self.name2len = load_name2len(data_info.get("name2len"),
                                      self.frame_path)
        self.sequence_len = opt.get("num_frames", 5)
        self.flow_direction = opt.get("flow_direction", "for")

    def frame_sample(self, frame_len: int) -> list:
        if self.sample_method == "random":
            return random.sample(range(frame_len), self.sequence_len)
        if self.sample_method == "seq":
            # the reference's randint bound is negative for real videos;
            # the JAX package takes the evidently intended one
            pivot = random.randint(0, frame_len - self.sequence_len)
            return list(range(pivot, pivot + self.sequence_len))
        raise ValueError(f"Cannot determine the sample method "
                         f"{self.sample_method}")

    def _read_flow_file(self, d: str, idx: int) -> np.ndarray:
        return flow_tf(read_flow(os.path.join(d, f"{idx:05d}.flo")),
                       self.height, self.width)

    def load_item(self, idx: int) -> dict:
        video = self.train_list[idx]
        frame_dir = os.path.join(self.frame_path, video)
        fwd_dir = os.path.join(self.flow_path, video, "forward_flo")
        bwd_dir = os.path.join(self.flow_path, video, "backward_flo")
        frame_len = self.name2len[video]
        flow_len = frame_len - 1
        if frame_len <= self.sequence_len:
            raise ValueError(f"Frame length {frame_len} is less than "
                             f"sequence length")
        indices = self.frame_sample(frame_len)
        cand = create_random_shape_with_random_motion(
            frame_len, 0.9, 1.1, 1, 10,
            imageHeight=self.height, imageWidth=self.width)

        frames, masks, fwd, bwd = [], [], [], []
        for i in indices:
            frames.append(read_frame(_frame_file(frame_dir, i),
                                     self.height, self.width))
            mask = resize_mask(cand[i], self.height, self.width)
            masks.append(mask)
            if self.flow_direction in ("for", "bi"):
                f = self._read_flow_file(fwd_dir, min(i, flow_len - 1))
                fwd.append(diffusion_fill(f, mask))
            if self.flow_direction in ("back", "bi"):
                f = self._read_flow_file(bwd_dir, max(i - 1, 0))
                bwd.append(diffusion_fill(f, mask))
            if self.flow_direction not in ("for", "back", "bi"):
                raise ValueError(
                    f"Unknown flow direction mode: {self.flow_direction}")

        out = {
            "frames": (np.stack(frames).astype(np.float32) / 255.0) * 2 - 1,
            "masks": np.stack(masks).astype(np.float32)[..., None],
        }
        if fwd:
            out["forward_flo"] = np.stack(fwd).astype(np.float32)
        if bwd:
            out["backward_flo"] = np.stack(bwd).astype(np.float32)
        return out


class _LAFCBase(_VideoListDataset):
    def __init__(self, opt: dict, data_info: dict):
        super().__init__(data_info["flow_path"])
        self.opt = opt
        self.sample_method = opt.get("sample", "seq")
        fcfg = data_info.get("flow", {})
        self.flow_height = fcfg.get("flow_height", 240)
        self.flow_width = fcfg.get("flow_width", 432)
        self.flow_path = data_info["flow_path"]
        self.frame_path = data_info["frame_path"]
        self.name2len = load_name2len(data_info.get("name2len"),
                                      self.frame_path)
        ecfg = data_info.get("edge", {})
        self.sigma = ecfg.get("sigma", 1)
        self.low_threshold = ecfg.get("low_threshold", 0.1)
        self.high_threshold = ecfg.get("high_threshold", 0.2)

    def read_frames(self, frame_dir: str, index: int, direction: str):
        if direction == "forward_flo":
            cur, shift = index, index + 1
        else:
            cur, shift = index + 1, index
        out = []
        for i in (cur, shift):
            f = read_frame(_frame_file(frame_dir, i),
                           self.flow_height, self.flow_width)
            out.append(f.astype(np.float32) / 255.0)
        return out[0], out[1]

    def load_edge(self, flow: np.ndarray):
        gray, edge = flow_edge(flow, sigma=self.sigma,
                               low_threshold=self.low_threshold,
                               high_threshold=self.high_threshold)
        return gray.astype(np.float32), edge.astype(np.float32)


class LAFCFlowDataset(_LAFCBase):
    """``num_flows`` flows at ``flow_interval`` around a pivot, plus the
    edge targets."""

    def __init__(self, opt: dict, data_info: dict):
        super().__init__(opt, data_info)
        self.sequence_len = opt.get("num_flows", 3)
        self.flow_interval = opt.get("flow_interval", 3)
        self.half_len = self.sequence_len // 2

    def frame_sample(self, flow_len: int) -> list:
        if self.sample_method == "random":
            return random.sample(range(flow_len), self.sequence_len)
        pivot = random.randint(0, flow_len - 1)
        return [int(np.clip(pivot + i * self.flow_interval, 0, flow_len - 1))
                for i in range(-self.half_len, self.half_len + 1)]

    def load_item(self, idx: int) -> dict:
        video = self.train_list[idx]
        direction = ("forward_flo" if np.random.uniform(0, 1) > 0.5
                     else "backward_flo")
        flow_dir = os.path.join(self.flow_path, video, direction)
        frame_dir = os.path.join(self.frame_path, video)
        flow_len = self.name2len[video] - 1
        if flow_len <= self.sequence_len:
            raise ValueError(f"Flow length {flow_len} is not enough")
        indices = self.frame_sample(flow_len)
        cand = create_random_shape_with_random_motion(
            self.sequence_len, 0.9, 1.1, 1, 10,
            imageHeight=self.flow_height, imageWidth=self.flow_width)

        flows, diffused, masks = [], [], []
        for k, i in enumerate(indices):
            flow = flow_tf(read_flow(os.path.join(flow_dir, f"{i:05d}.flo")),
                           self.flow_height, self.flow_width)
            mask = resize_mask(cand[k], self.flow_height, self.flow_width)
            flows.append(flow)
            masks.append(mask)
            diffused.append(diffusion_fill(flow, mask))

        target = indices[self.half_len]
        current, shift = self.read_frames(frame_dir, target, direction)
        flow_gray, edge = self.load_edge(flows[self.half_len])
        return {
            "flows": np.stack(flows).astype(np.float32),
            "diffused_flows": np.stack(diffused).astype(np.float32),
            "masks": np.stack(masks).astype(np.float32)[..., None],
            "current_frame": current,
            "shift_frame": shift,
            "edges": edge[..., None],
            "flow_gray": flow_gray[..., None],
        }


class LAFCSingleFlowDataset(_LAFCBase):
    """One flow, its mask, the frame pair and the edge (the 2D
    LAFC-single recipe)."""

    def frame_sample(self, flow_len: int) -> int:
        return random.randint(0, flow_len - 1)

    def load_item(self, idx: int) -> dict:
        video = self.train_list[idx]
        direction = ("forward_flo" if np.random.uniform(0, 1) > 0.5
                     else "backward_flo")
        flow_dir = os.path.join(self.flow_path, video, direction)
        frame_dir = os.path.join(self.frame_path, video)
        flow_len = self.name2len[video] - 1
        pivot = self.frame_sample(flow_len)
        cand = create_random_shape_with_random_motion(
            1, 0.9, 1.1, 1, 10,
            imageHeight=self.flow_height, imageWidth=self.flow_width)
        flow = flow_tf(read_flow(os.path.join(flow_dir, f"{pivot:05d}.flo")),
                       self.flow_height, self.flow_width)
        mask = resize_mask(cand[0], self.flow_height, self.flow_width)
        diffused = diffusion_fill(flow, mask)
        current, shift = self.read_frames(frame_dir, pivot, direction)
        _, edge = self.load_edge(flow)
        return {
            "flows": flow.astype(np.float32),
            "diffused_flows": diffused.astype(np.float32),
            "masks": mask.astype(np.float32)[..., None],
            "current_frame": current,
            "shift_frame": shift,
            "edges": edge[..., None],
        }
