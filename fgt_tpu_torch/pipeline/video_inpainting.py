"""Video inpainting driver — the port's counterpart of
``fgt_tpu/pipeline/video_inpainting.py`` (reference
tool/video_inpainting.py), in its three modes: object removal, watermark
removal (frames premasked at the source size) and video extrapolation
(the frames centred in an enlarged canvas whose border is the hole).

Stages (device work on the card unless the caller asks for the CPU):

  s1 RAFT     encode every frame once (2x upscale under 350 px), then
              forward and backward pairs batched through one refine;
              big RAFT, or the small variant under ``--small``;
              correlation from kernel K1 (``--fused_corr auto|on``), from
              K1 in f32 (``--alternate_corr``, which wins over
              ``--fused_corr``) or from the all-pairs pyramid looked up
              by kernel K3 (``--fused_corr off``); flows resized to image
              resolution with an antialiased bilinear filter
  s1b         extrapolation only: the canvas, zero-padded flows and the
              border masks
  s2 LAFC     device diffusion (multigrid-preconditioned CG), or the
              host's multigrid solve under ``--host_diffusion``, then the
              P3D net over reflect-indexed windows, pivot composite
  s3 host     gradients (forward differences, hole-touching ones zeroed)
  s3b RAFT    ``--Nonlocal`` only: flows between every frame and the key
              frames [0, N//2, N-1], on the pyramid path (K3), or K1 in
              f32 under ``--alternate_corr``
  s4 host     flowNN gradient propagation (native OpenMP kernels)
  s5 host     Poisson blending (scipy splu)
  s6 FGT      batched windows, temporal attention through kernel K2,
              ordered 50/50 composite in pivot order, trunc-cast to u8;
              under ``--exact_windows`` one forward per window at the
              reference's own shapes (neighbours truncated at the ends)

Entry points: :func:`inpaint` (arrays in, arrays out) and
:func:`video_inpainting` (the CLI: ``.npy`` stacks or PNG / JPEG
directories in, ``result.npy``, ``result.mp4`` (H.264 I_PCM at 30 fps,
``core/video_io.py``), PNGs and one line appended to
``timings.jsonl`` (the JAX CLI's record: synchronized stage seconds,
their total, minor page faults a stage, the frame count, the mode and
the OOM back-offs)). The CLI's debug flags write what the JAX CLI
writes, in the same directories: ``--vis_flows`` (the s1 flows under
``flow/``), ``--vis_completed_flows`` (s2's under ``completed_flow/``),
``--vis_prop`` (the Poisson frames and the pixels left for FGT);
``--opt`` overrides flags from a YAML file, ``--profile`` writes a
``torch.profiler`` trace and the records of the spans recorded under it
(``utils/profiling.py``: a root ``inpaint``, a span per stage, inside
them s1's encode and refine, s2's diffusion and LAFC windows, s6's
forwards and composites, and the counters ``pcg_iters`` and
``poisson_px``).

Multi-GPU serving (the JAX CLI's ``--dp``, ``--tp``, ``--sp``; one
process per card, e.g. ``torchrun --nproc_per_node 2 -m
fgt_tpu_torch.pipeline.video_inpainting ... --tp 2``, or a group the
caller initialised): with more than one rank, the ranks form a (dp, tp,
sp) mesh (``parallel/mesh.py``). Each dp rank runs its share of every
batched chunk, the pairs of s1 and s3b (K1 or K3), the windows of s2 and
of s6 (K2), and the shares are all-gathered; a chunk that dp does not
divide runs replicated, with one warning per size. The chunk sizes are
at least dp. Under tp the FGT generator is Megatron-sharded and under sp
its frames are (``parallel/partition.py``, ``models/fgt.py``). s2's
diffusion takes the host solve, as the JAX CLI's does under a mesh. The
host stages give the same result on every rank; only rank 0 writes
``outroot``. The kernels run under the mesh as without it.

Frames stay float from the resize on, as in the JAX pipeline: RAFT reads
them rounded to u8, the gradients and Poisson read them /255, and FGT's
input and the composite read them rounded again.

The hole is never seeded with cv2's TELEA inpainting as the JAX pipeline
does: every value it would put there is zeroed out of the gradients,
solved by Poisson, or masked out of FGT's input and replaced in the
composite (``tests/test_torch_port_telea.py`` checks this on the JAX
pipeline, in object removal and extrapolation).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import resource
import time
from typing import Optional

import numpy as np
import scipy.ndimage
import torch
import torch.nn.functional as F

from fgt_tpu_torch import DEFAULT_DEVICE, native
from fgt_tpu_torch.convert.weights import load_state, load_weights
from fgt_tpu_torch.core import flow_io, flow_viz, video_io
from fgt_tpu_torch.models import fgt as fgt_mod
from fgt_tpu_torch.models import lafc as lafc_mod
from fgt_tpu_torch.models import raft as raft_mod
from fgt_tpu_torch.ops.diffusion import diffuse_flows_device
from fgt_tpu_torch.parallel.collectives import gather_frames
from fgt_tpu_torch.parallel.mesh import make_mesh
from fgt_tpu_torch.parallel.partition import shard_module, tp_param_fraction
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline.poisson import poisson_blend
from fgt_tpu_torch.pipeline.propagation import (PropagationConfig,
                                                get_flownn_gradient,
                                                get_flownn_gradient_frames,
                                                key_frames)
from fgt_tpu_torch.utils import dist
from fgt_tpu_torch.utils.config import apply_yaml_over_args, read_flat_yaml
from fgt_tpu_torch.utils.profiling import maybe_trace, span

logger = logging.getLogger("fgt_tpu_torch")

DEFAULT_LAFC_CONFIG = {
    "model": "lafc", "num_flows": 3, "flow_interval": 3, "cnum": 48,
    "in_channel": 3, "PASSMASK": 1, "use_residual": 1, "resBlocks": 1,
    "use_bias": 1, "conv_type": "vanilla", "init_weights": 1, "use_edges": 0,
}
DEFAULT_FGT_CONFIG = {
    "model": "model", "in_channel": 4, "cnum": 64, "flow_inChannel": 2,
    "flow_cnum": 64, "frame_hidden": 512, "flow_hidden": 256, "PASSMASK": 1,
    "numBlocks": 8, "num_head": 4, "conv_type": "vanilla", "norm": None,
    "use_bias": 1, "ape": 1, "mlp_ratio": 40, "drop": 0, "init_weights": 1,
    "tw": 2, "sw": 8, "gd": 4, "kernel_size_w": 7, "kernel_size_h": 7,
    "stride_h": 3, "stride_w": 3, "pad_h": 3, "pad_w": 3,
    "res_h": 240, "res_w": 432, "num_frames": 5, "flow_direction": "for",
}
RAFT_ENCODE_CHUNK = 8
MODES = ("object_removal", "watermark_removal", "video_extrapolation")


# ---------------- helpers (own copies of the JAX pipeline's) ----------------

def indices_gen(pivot: int, interval: int, frames: int, t: int) -> list:
    """Reflect-padded window indices around a pivot (reference :90-100)."""
    out = []
    for i in range(-(frames // 2), frames // 2 + 1):
        idx = pivot + interval * i
        if idx < 0:
            idx = abs(idx)
        if idx > t - 1:
            idx = 2 * (t - 1) - idx
        out.append(idx)
    return out


def get_ref_index(f: int, neighbor_ids: list, length: int, ref_length: int,
                  num_ref: int) -> list:
    """Dilated global reference frames (reference :103-117)."""
    ref_index = []
    if num_ref == -1:
        for i in range(0, length, ref_length):
            if i not in neighbor_ids:
                ref_index.append(i)
    else:
        start = max(0, f - ref_length * (num_ref // 2))
        end = min(length, f + ref_length * (num_ref // 2))
        for i in range(start, end + 1, ref_length):
            if i not in neighbor_ids:
                if len(ref_index) > num_ref:
                    break
                ref_index.append(i)
    return ref_index


def norm_flows(flows: torch.Tensor) -> torch.Tensor:
    """Per-frame, per-channel division by the signed spatial max; a zero
    max maps to divisor 1 (reference :402-407)."""
    n, h, w, c = flows.shape
    fmax = flows.reshape(n, h * w, c).amax(dim=1)[:, None, None, :]
    return flows / torch.where(fmax == 0, torch.ones_like(fmax), fmax)


def gradient_mask(mask: np.ndarray) -> np.ndarray:
    """Expand a hole mask by one pixel down and right (reference :74-87)."""
    down = np.concatenate((mask[1:, :], np.zeros((1, mask.shape[1]), bool)), 0)
    right = np.concatenate((mask[:, 1:], np.zeros((mask.shape[0], 1), bool)), 1)
    return np.logical_or.reduce((mask, down, right))


def fgt_window_ids(n: int, neighbor_stride: int, step: int, num_ref: int):
    """Fixed-shape window index matrix [W, T] (clamped neighbor windows +
    padded global refs) and the neighbor count t_n."""
    t_n = min(n, 2 * neighbor_stride + 1)
    window_neighbors, window_refs = [], []
    for f in range(0, n, neighbor_stride):
        start = int(np.clip(f - neighbor_stride, 0, n - t_n))
        window_neighbors.append(list(range(start, start + t_n)))
        window_refs.append(get_ref_index(f, window_neighbors[-1], n, step,
                                         num_ref))
    n_ref = max(len(r) for r in window_refs)
    for neigh, refs in zip(window_neighbors, window_refs):
        extra = (i for i in range(n) if i not in refs and i not in neigh)
        while len(refs) < n_ref:
            refs.append(next(extra, refs[-1] if refs else neigh[-1]))
    ids = np.asarray([ne + re for ne, re in
                      zip(window_neighbors, window_refs)], np.int64)
    return ids, t_n


def prepare_gradients(video: np.ndarray, mask: np.ndarray,
                      mask_dilated: np.ndarray):
    """Forward differences with every hole-touching one zeroed
    (reference :584-619, without the TELEA seed).

    video: [N, H, W, 3] f32 in [0, 1]; mask/mask_dilated: [N, H, W] bool.
    Each frame goes through uint8 as the reference's seed does (trunc of
    ·255, then /255: exact for u8-valued frames, a floor for resized
    ones). Returns (that video with the hole zeroed, gx, gy)."""
    n, h, w, _ = video.shape
    gx = np.zeros((n, h, w, 3), np.float32)
    gy = np.zeros((n, h, w, 3), np.float32)
    video = video.copy()
    for i in range(n):
        img = video[i].copy()
        img[mask[i]] = 0
        img = (img * 255).astype(np.uint8).astype(np.float32) / 255.0
        gx[i, :, :-1] = np.diff(img, axis=1)
        gy[i, :-1, :] = np.diff(img, axis=0)
        gx[i][mask_dilated[i]] = 0
        gy[i][mask_dilated[i]] = 0
        video[i] = img
    return video, gx, gy


def chunk_backoff(dispatch, chunk: int, stage: str,
                  backoffs: Optional[list] = None):
    """Run ``dispatch(chunk)``, halving the chunk and retrying on device
    OOM. Each retry is logged (and appended to ``backoffs`` if given)."""
    while True:
        try:
            return dispatch(chunk), chunk
        except torch.cuda.OutOfMemoryError:
            if chunk <= 1:
                raise
            smaller = chunk // 2
            logger.warning("%s: device OOM at chunk %d; retrying with %d",
                           stage, chunk, smaller)
            if backoffs is not None:
                backoffs.append((stage, chunk, smaller))
            torch.cuda.empty_cache()
            chunk = smaller


class StageTimer:
    """Per-stage wall seconds and minor page faults (``ru_minflt``, as the
    JAX CLI's timer counts them). On a CUDA device it synchronizes before
    a stage starts and before it stops, so device work is charged to the
    stage that queued it."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.times: dict = {}
        self.faults: dict = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.times[name] = self.times.get(name, 0.0) + \
                time.perf_counter() - t0
            self.faults[name] = self.faults.get(name, 0) + (
                resource.getrusage(resource.RUSAGE_SELF).ru_minflt - f0)

    def total(self) -> float:
        return sum(self.times.values())

    def dump(self, path: str, **extra) -> None:
        """Append one JSON line: the JAX CLI's ``timings.jsonl`` record."""
        rec = {"stages": self.times, "total": self.total(),
               "minor_faults": self.faults, **extra}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def stage(timer, name: str):
    """Stage ``name`` on ``timer`` (a :class:`StageTimer` or any object
    with its ``stage``) and as a span of the same name inside it."""
    with timer.stage(name), span(name):
        yield


# ---------------- models ----------------

class Models:
    """RAFT + LAFC + FGT on one device, in one dtype, random-initialized
    from ``seed`` (a ``torch.Generator``) unless state dicts are given.
    ``small`` takes RAFT's small variant. ``corr`` is s1's correlation
    path ("fused": K1, "alternate": K1 in f32, "pyramid": K3); the
    pyramid is stored in bf16 under bf16 compute unless ``corr_f32``.

    ``mesh`` (``parallel.mesh.make_mesh``) serves on several ranks: the
    batched chunks are shared over its dp ranks (:meth:`dp_share`), the
    FGT generator is built from the full init and weights, then sharded
    over tp and, with sp > 1, over its frames."""

    mesh = None      # one process unless __init__ is given a mesh

    def __init__(self, device: str = DEFAULT_DEVICE, bf16: bool = True,
                 raft_iters: int = 20, lafc_config: Optional[dict] = None,
                 fgt_config: Optional[dict] = None, seed: int = 0,
                 raft_state=None, lafc_state=None, fgt_state=None,
                 corr: str = "fused", corr_f32: bool = False,
                 small: bool = False, mesh=None):
        if corr not in raft_mod.CORRS:
            raise ValueError(f"unknown correlation path {corr!r}")
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.corr = corr
        self.corr_dtype = torch.float32 if corr_f32 else self.dtype
        self.raft_iters = raft_iters
        self.lafc_config = dict(lafc_config or DEFAULT_LAFC_CONFIG)
        self.fgt_config = dict(fgt_config or DEFAULT_FGT_CONFIG)
        self.mesh = mesh
        self._dp_warned: set = set()
        if mesh is not None and mesh.sp > 1:
            self.fgt_config["seq_axis"] = "sp"
        gen = torch.Generator().manual_seed(seed)
        self.raft = raft_mod.init_raft(raft_mod.RAFT(small), gen)
        self.lafc = lafc_mod.init_lafc(lafc_mod.Model(self.lafc_config), gen)
        self.fgt = fgt_mod.init_fgt(fgt_mod.Model(self.fgt_config), gen)
        for module, state in ((self.raft, raft_state),
                              (self.lafc, lafc_state),
                              (self.fgt, fgt_state)):
            if state is not None:
                load_state(module, state)
            if module is self.fgt and mesh is not None and (
                    mesh.tp > 1 or mesh.sp > 1):
                logger.info("dp=%d x tp=%d x sp=%d inference mesh; %.3f of "
                            "FGT params tp-sharded", mesh.dp, mesh.tp,
                            mesh.sp, tp_param_fraction(module.state_dict(),
                                                       mesh.tp))
                shard_module(module, mesh)
            module.to(device=self.device, dtype=self.dtype).eval()
        for p in (*self.raft.parameters(), *self.lafc.parameters(),
                  *self.fgt.parameters()):
            p.requires_grad_(False)

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    def dp_share(self, n: int, stage: str) -> Optional[slice]:
        """This rank's rows of a batched chunk of ``n`` under a mesh of
        dp > 1 ranks (gather the results with :meth:`dp_gather`); None
        when the chunk runs whole here: no such mesh, or dp does not
        divide ``n`` (replicated, warned once per stage and size, as the
        JAX CLI's ``shard_chunk``)."""
        dp = self.dp
        if dp == 1:
            return None
        if n % dp:
            if (stage, n) not in self._dp_warned:
                self._dp_warned.add((stage, n))
                logger.warning("--dp: %s chunk of %d does not divide the %d "
                               "dp ranks; running REPLICATED (no dp speedup) "
                               "for this shape", stage, n, dp)
            return None
        i = self.mesh.index("dp")
        return slice(i * n // dp, (i + 1) * n // dp)

    def dp_gather(self, part: torch.Tensor) -> torch.Tensor:
        """Every dp rank's share of a chunk, in rank order."""
        return gather_frames(part, [part.shape[0]] * self.dp,
                             self.mesh.group("dp"))


# ---------------- stages ----------------

def resize_flows(flow: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[B, H, W, 2] -> [B, out_h, out_w, 2] with the vectors rescaled:
    bilinear with antialiasing when shrinking, the counterpart of
    ``jax.image.resize(..., "bilinear")``."""
    b, h, w, _ = flow.shape
    if (h, w) == (out_h, out_w):
        return flow
    out = F.interpolate(flow.permute(0, 3, 1, 2), size=(out_h, out_w),
                        mode="bilinear", align_corners=False, antialias=True)
    scale = torch.tensor([out_w / w, out_h / h], dtype=flow.dtype,
                         device=flow.device)
    return out.permute(0, 2, 3, 1) * scale


def encode_frames(models: Models, video_u8: torch.Tensor, flow_h: int,
                  flow_w: int):
    """RAFT features (fmap, net, inp) of every frame at flow resolution;
    ``video_u8`` [N, H, W, 3] on the device is upscaled there (bilinear)
    when it is not at flow resolution yet."""
    h, w = video_u8.shape[1:3]
    feats = []
    for s in range(0, video_u8.shape[0], RAFT_ENCODE_CHUNK):
        fr = video_u8[s:s + RAFT_ENCODE_CHUNK].to(models.dtype)
        if (h, w) != (flow_h, flow_w):
            fr = F.interpolate(fr.permute(0, 3, 1, 2), size=(flow_h, flow_w),
                               mode="bilinear", align_corners=False
                               ).permute(0, 2, 3, 1)
        feats.append(models.raft.encode(fr))
    return tuple(torch.cat(parts, dim=0) for parts in zip(*feats))


def refine_pairs(models: Models, feats, src: torch.Tensor, dst: torch.Tensor,
                 out_h: int, out_w: int, chunk: Optional[int], corr: str,
                 stage: str, backoffs: Optional[list] = None) -> torch.Tensor:
    """Flows src[i] -> dst[i] from encoded features, ``chunk`` pairs per
    refine (all by default, halved on device OOM), resized to
    [P, out_h, out_w, 2] f32."""
    fmap, net, inp = feats

    def dispatch(c):
        outs = []
        for s in range(0, src.shape[0], c):
            i, j = src[s:s + c], dst[s:s + c]
            share = models.dp_share(i.shape[0], stage)
            if share is not None:
                i, j = i[share], j[share]
            _, up = models.raft.refine(fmap[i], fmap[j], net[i], inp[i],
                                       models.raft_iters, corr=corr,
                                       corr_dtype=models.corr_dtype)
            fl = resize_flows(up.float(), out_h, out_w)
            outs.append(fl if share is None else models.dp_gather(fl))
        return torch.cat(outs, dim=0)

    flows, _ = chunk_backoff(dispatch, chunk or src.shape[0], stage, backoffs)
    return flows


def calculate_flows(models: Models, video_u8: torch.Tensor, flow_h: int,
                    flow_w: int, chunk: Optional[int] = None,
                    backoffs: Optional[list] = None,
                    out_hw: Optional[tuple] = None):
    """s1: forward and backward RAFT flows, f32 [N-1, H, W, 2] each at
    ``out_hw`` (default: the video's resolution). ``video_u8``:
    [N, H, W, 3] on the device, at image or flow resolution."""
    n, h, w = video_u8.shape[:3]
    out_h, out_w = out_hw or (h, w)
    with span("s1.encode"):
        feats = encode_frames(models, video_u8, flow_h, flow_w)
    ar = torch.arange(n - 1, device=video_u8.device)
    with span("s1.refine"):
        flows = refine_pairs(models, feats, torch.cat([ar, ar + 1]),
                             torch.cat([ar + 1, ar]), out_h, out_w, chunk,
                             models.corr, "s1_raft", backoffs)
    return flows[:n - 1], flows[n - 1:]


def calculate_nonlocal_flows(models: Models, video_u8: torch.Tensor,
                             out_h: int, out_w: int,
                             chunk: Optional[int] = None,
                             backoffs: Optional[list] = None):
    """s3b, ``--Nonlocal``: flows between every frame and the key frames
    [0, N//2, N-1] on the all-pairs pyramid path (K3), or on K1 in f32
    when s1 takes it, as the JAX package's ``calculate_nonlocal_flows``.
    ``video_u8``: [N, H, W, 3] at flow resolution on the device. Returns
    (nl_f, nl_b), each f32
    [N, 3, out_h, out_w, 2]: nl_f[t, k] is the flow t -> key k, nl_b[t, k]
    the flow key k -> t."""
    n, fh, fw = video_u8.shape[:3]
    feats = encode_frames(models, video_u8, fh, fw)
    keys = torch.tensor(key_frames(n), device=video_u8.device)
    t_idx = torch.arange(n, device=video_u8.device).repeat_interleave(3)
    k_idx = keys.repeat(n)
    corr = "alternate" if models.corr == "alternate" else "pyramid"
    nl = [refine_pairs(models, feats, a, b, out_h, out_w, chunk, corr,
                       "s3b_nonlocal", backoffs).reshape(n, 3, out_h, out_w, 2)
          for a, b in ((t_idx, k_idx), (k_idx, t_idx))]
    return nl[0], nl[1]


def complete_flows(models: Models, flows: torch.Tensor, masks: torch.Tensor,
                   chunk: int = 16, backoffs: Optional[list] = None,
                   host_diffusion: bool = False):
    """s2: diffusion + LAFC over reflect-indexed windows, composited at
    the pivot as out·m + flow·(1-m). flows: [T, H, W, 2] f32; masks:
    [T, H, W] {0,1} on the device. The diffusion runs on the device, or
    with ``host_diffusion`` through the host's multigrid solve
    (``native.diffuse_flows``, the JAX package's ``diffusion()``).
    Returns f32 [T, H, W, 2]."""
    cfg = models.lafc_config
    num_flows, interval = cfg["num_flows"], cfg.get("flow_interval", 3)
    t, h, w, _ = flows.shape
    with span("s2.diffusion"):
        if host_diffusion:
            diffused = torch.from_numpy(native.diffuse_flows(
                flows.cpu().numpy(), masks.cpu().numpy() > 0)).to(
                    flows.device)
        else:
            diffused = diffuse_flows_device(flows, masks)
    ids = torch.tensor([indices_gen(i, interval, num_flows, t)
                        for i in range(t)], device=flows.device)
    mf = masks.float()

    def dispatch(c):
        outs = []
        for s in range(0, t, c):
            ib = ids[s:s + c]
            share = models.dp_share(ib.shape[0], "s2_lafc")
            mine = ib if share is None else ib[share]
            b = mine.shape[0]
            wf = diffused[mine.reshape(-1)].reshape(b, num_flows, h, w, 2)
            wm = mf[mine.reshape(-1)].reshape(b, num_flows, h, w, 1)
            out, _ = models.lafc(wf, wm, with_edge=False)
            out = out.float() if share is None else \
                models.dp_gather(out.float())
            piv = ib[:, num_flows // 2]
            pm = mf[piv][..., None]
            outs.append(out * pm + flows[piv] * (1 - pm))
        return torch.cat(outs, dim=0)

    with span("s2.lafc_net"):
        out, _ = chunk_backoff(dispatch, chunk, "s2_lafc", backoffs)
    return out


def fgt_synthesis(models: Models, video_u8: torch.Tensor,
                  masks_u8: torch.Tensor, flows_f: torch.Tensor,
                  neighbor_stride: int = 5, step: int = 10,
                  num_ref: int = -1, window_batch: int = 6,
                  backoffs: Optional[list] = None) -> torch.Tensor:
    """s6: FGT over fixed-shape windows, batched, composited in pivot
    order (new = out·m + valid·(1-m); an already-seen frame averages
    50/50; f32 accumulation, one trunc-cast to u8 at the end).

    video_u8: [N, H, W, 3] (round-cast Poisson output); masks_u8:
    [N, H, W] (pixels left for FGT); flows_f: [N-1, H, W, 2] completed
    forward flows. Returns [N, H, W, 3] u8."""
    n, h, w, _ = video_u8.shape
    ids_np, t_n = fgt_window_ids(n, neighbor_stride, step, num_ref)
    ids_all = torch.from_numpy(ids_np).to(video_u8.device)
    w_total, t = ids_np.shape
    flows = norm_flows(torch.cat([flows_f, flows_f[-1:]], dim=0).float())
    flows = flows.to(models.dtype)
    mf = masks_u8.float()[..., None]
    vf = video_u8.float()

    def dispatch(wb):
        comp = torch.zeros(n, h, w, 3, dtype=torch.float32,
                           device=video_u8.device)
        seen = torch.zeros(n, dtype=torch.bool, device=video_u8.device)
        for s in range(0, w_total, wb):
            ib = ids_all[s:s + wb]
            share = models.dp_share(ib.shape[0], "s6_fgt")
            mine = ib if share is None else ib[share]
            b = mine.shape[0]
            flat = mine.reshape(-1)
            fr = video_u8[flat].to(models.dtype).reshape(b, t, h, w, 3) / 255.0
            fr = fr * 2.0 - 1.0
            m = masks_u8[flat].to(models.dtype).reshape(b, t, h, w, 1)
            fl = flows[flat].reshape(b, t, h, w, 2)
            with span("s6.forward"):
                out = models.fgt(fr * (1 - m), fl, m)
                out_u8 = ((out.float() + 1.0) / 2.0 * 255.0).to(torch.uint8)
            if share is not None:
                out_u8 = models.dp_gather(out_u8)
            with span("s6.composite"):
                for j in range(ib.shape[0]):
                    nb = ib[j, :t_n]
                    mj = mf[nb]
                    new = out_u8[j, :t_n].float() * mj + vf[nb] * (1 - mj)
                    sj = seen[nb][:, None, None, None]
                    comp[nb] = torch.where(sj, 0.5 * comp[nb] + 0.5 * new,
                                           new)
                    seen[nb] = True
        return comp.to(torch.uint8)

    comp, _ = chunk_backoff(dispatch, max(1, min(window_batch, w_total)),
                            "s6_fgt", backoffs)
    return comp


def fgt_synthesis_exact(models: Models, frames: np.ndarray,
                        masks_u8: torch.Tensor, flows_f: torch.Tensor,
                        neighbor_stride: int = 5, step: int = 10,
                        num_ref: int = -1) -> torch.Tensor:
    """s6 at the reference's own window shapes (``--exact_windows``): one
    FGT forward per pivot over its neighbours, truncated at the video's
    ends, and its global reference frames, as the JAX package's
    ``fgt_synthesis(exact_windows=True)``. Its input is the float Poisson
    output, not a rounded copy: FGT reads frames·2-1 (f64, cast once to
    f32) and the composite keeps trunc(frames·255) outside the hole.

    frames: [N, H, W, 3] float in [0, 1] on the host; masks_u8: [N, H, W]
    (pixels left for FGT); flows_f: [N-1, H, W, 2] completed forward
    flows. Returns [N, H, W, 3] u8."""
    n, h, w, _ = frames.shape
    dev = masks_u8.device
    flows = norm_flows(torch.cat([flows_f, flows_f[-1:]], dim=0).float())
    flows = flows.to(models.dtype)
    mf = masks_u8.float()[..., None]
    normed = torch.from_numpy((frames * 2 - 1).astype(np.float32)).to(dev)
    valid = torch.from_numpy((frames * 255.0).astype(np.uint8)).to(dev)
    comp = torch.zeros(n, h, w, 3, dtype=torch.float32, device=dev)
    seen = set()
    for f in range(0, n, neighbor_stride):
        neighbor_ids = list(range(max(0, f - neighbor_stride),
                                  min(n, f + neighbor_stride + 1)))
        ids = neighbor_ids + get_ref_index(f, neighbor_ids, n, step, num_ref)
        sel = torch.tensor(ids, device=dev)
        m = mf[sel]
        masked = (normed[sel] * (1 - m)).to(models.dtype)[None]
        with span("s6.forward"):
            out = models.fgt(masked, flows[sel][None],
                             m.to(models.dtype)[None])[0]
            out_u8 = ((out.float() + 1.0) / 2.0 * 255.0).to(torch.uint8)
        with span("s6.composite"):
            for k, idx in enumerate(neighbor_ids):
                new = out_u8[k].float() * mf[idx] + valid[idx].float() * (
                    1 - mf[idx])
                comp[idx] = (0.5 * comp[idx] + 0.5 * new if idx in seen
                             else new)
                seen.add(idx)
    return comp.to(torch.uint8)


def extrapolation(video: np.ndarray, flows_f: torch.Tensor,
                  flows_b: torch.Tensor, h_scale: float, w_scale: float):
    """Canvas enlargement for outpainting (reference :291-339): the
    canvas is int(s·h) - int(s·h) % 4 per axis, the frames and flows are
    centred in it (zero border), and the border is the hole.

    video: [N, H, W, 3] f32 in [0, 1]; flows on the device. Returns (canvas
    video, padded flows_f, flows_b, border mask [h2, w2] bool, its
    gradient mask)."""
    n, h, w, _ = video.shape
    h2 = int(h_scale * h) - int(h_scale * h) % 4
    w2 = int(w_scale * w) - int(w_scale * w) % 4
    y0, x0 = (h2 - h) // 2, (w2 - w) // 2
    flow_mask = np.ones((h2, w2), dtype=bool)
    flow_mask[y0:y0 + h, x0:x0 + w] = False
    big = np.zeros((n, h2, w2, 3), np.float32)
    big[:, y0:y0 + h, x0:x0 + w] = video
    padded = []
    for fl in (flows_f, flows_b):
        p = fl.new_zeros(fl.shape[0], h2, w2, 2)
        p[:, y0:y0 + h, x0:x0 + w] = fl
        padded.append(p)
    return big, padded[0], padded[1], flow_mask, gradient_mask(flow_mask)


def inpaint(frames: np.ndarray, masks: Optional[np.ndarray], models: Models,
            mode: str = "object_removal", h_scale: float = 2.0,
            w_scale: float = 2.0, use_nonlocal: bool = False,
            flow_mask_dilates: int = 8, frame_dilates: int = 0,
            consistency_thres: float = 5.0, alpha: float = 0.1,
            neighbor_stride: int = 5, step: int = 10, num_ref: int = -1,
            raft_chunk: Optional[int] = None, lafc_chunk: Optional[int] = None,
            window_batch: Optional[int] = None, host_upscale: bool = False,
            timer: Optional[StageTimer] = None, vis: tuple = (),
            vis_root: Optional[str] = None, exact_windows: bool = False,
            host_diffusion: bool = False,
            backoffs: Optional[list] = None) -> np.ndarray:
    """Video inpainting on arrays. frames: [N, H, W, 3], uint8 or float in
    [0, 255] (a resized source); masks: [N, H, W] (nonzero = hole),
    unused by video extrapolation, whose hole is the canvas border.
    ``host_upscale`` takes RAFT's flow-resolution frames from a host
    resize of the float frames, rounded (the JAX loader's path when the
    source size differs from the image size), instead of upscaling the
    rounded frames on the device.

    Returns the inpainted [N, H', W', 3] uint8 frames (H', W' the canvas
    under extrapolation); outside the hole they equal the input, truncated
    to uint8 where it was float (as the JAX CLI's).

    ``vis`` names the debug outputs to write under ``vis_root``, as the
    JAX CLI's flags: "flows" (s1's flows), "completed_flows" (s2's),
    "prop" (the Poisson frames and the pixels left for FGT).

    ``exact_windows`` runs s6 at the reference's per-window shapes on the
    float Poisson frames (:func:`fgt_synthesis_exact`); ``host_diffusion``
    runs s2's regionfill on the host (:func:`complete_flows`).

    ``backoffs`` (a list) receives the ``(stage, chunk, smaller)`` triple
    of every chunk halved after a device OOM."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if models.mesh is not None:
        # as the JAX CLI under a mesh: the host solve, the debug outputs
        # written once, chunks of at least dp
        host_diffusion = True
        vis = vis if dist.rank() == 0 else ()
        raft_chunk = raft_chunk and max(raft_chunk, models.dp)
    if set(vis) - set(VIS) or (vis and vis_root is None):
        raise ValueError(f"vis {vis!r} needs names of {VIS} and a vis_root")
    dev = models.device
    timer = timer or StageTimer(dev)
    backoffs = [] if backoffs is None else backoffs
    video255 = np.asarray(frames, np.float32)
    n, img_h, img_w = video255.shape[:3]
    flow_h, flow_w = ((img_h * 2, img_w * 2) if img_h < 350
                      else (img_h, img_w))

    def to_u8(v):
        return np.clip(np.round(v), 0, 255).astype(np.uint8)

    def flow_frames():
        """The JAX pipeline's host flow-resolution frames, rounded."""
        return to_u8(image_io.resize_linear(video255, flow_h, flow_w))

    with span("inpaint", device=dev, frames=n), torch.inference_mode():
        with stage(timer, "s1_raft"):
            rgb = flow_frames() if host_upscale else to_u8(video255)
            flows_f, flows_b = calculate_flows(
                models, torch.from_numpy(rgb).to(dev), flow_h, flow_w,
                raft_chunk, backoffs, out_hw=(img_h, img_w))
        if "flows" in vis:
            save_flows(vis_root, flows_f.cpu().numpy(),
                       flows_b.cpu().numpy(), subdir="flow")
        video = video255 / 255.0
        if mode == "video_extrapolation":
            with stage(timer, "s1b_extrapolation"):
                video, flows_f, flows_b, fm2d, md2d = extrapolation(
                    video, flows_f, flows_b, h_scale, w_scale)
                img_h, img_w = video.shape[1:3]
                mask = np.repeat(fm2d[None], n, 0)
                flow_mask = mask.copy()
                mask_dilated = np.repeat(md2d[None], n, 0)
        else:
            holes = np.asarray(masks) > 0
            flow_mask = np.stack([
                scipy.ndimage.binary_dilation(m, iterations=flow_mask_dilates)
                if flow_mask_dilates > 0 else m for m in holes])
            mask = np.stack([
                scipy.ndimage.binary_dilation(m, iterations=frame_dilates)
                if frame_dilates > 0 else m for m in holes])
            mask_dilated = np.stack([gradient_mask(m) for m in mask])
        # batch sizes tuned at 240x432, scaled with the canvas pixel count
        pixel_scale = (240 * 432) / float(img_h * img_w)
        lafc_chunk = max(lafc_chunk or max(1, int(16 * pixel_scale)),
                         models.dp)
        window_batch = max(window_batch or max(1, int(6 * pixel_scale)),
                           models.dp)

        with stage(timer, "s2_lafc"):
            fm = torch.from_numpy(flow_mask.astype(np.uint8)).to(dev)
            comp_f = complete_flows(models, flows_f, fm[:-1], lafc_chunk,
                                    backoffs, host_diffusion)
            comp_b = complete_flows(models, flows_b, fm[1:], lafc_chunk,
                                    backoffs, host_diffusion)
            flow_f_np = comp_f.cpu().numpy()
            flow_b_np = comp_b.cpu().numpy()
        if "completed_flows" in vis:
            save_flows(vis_root, flow_f_np, flow_b_np)

        with stage(timer, "s3_gradients"):
            video, gx, gy = prepare_gradients(video, mask, mask_dilated)
        nl = None
        if use_nonlocal:
            with stage(timer, "s3b_nonlocal_flows"):
                nl_f, nl_b = calculate_nonlocal_flows(
                    models, torch.from_numpy(flow_frames()).to(dev), img_h,
                    img_w, raft_chunk, backoffs)
                # propagation layout [H, W, 2, 3, N]
                nl = [a.cpu().numpy().transpose(2, 3, 4, 1, 0)
                      for a in (nl_f, nl_b)]
        with stage(timer, "s4_flownn"):
            pcfg = PropagationConfig(consistency_thres, alpha)
            if nl is None:
                gx, gy, mask_tofill = get_flownn_gradient_frames(
                    pcfg, gx, gy, mask, flow_f_np, flow_b_np)
            else:
                gx, gy, mask_tofill = get_flownn_gradient(
                    pcfg, gx.transpose(1, 2, 3, 0), gy.transpose(1, 2, 3, 0),
                    mask.transpose(1, 2, 0), flow_f_np.transpose(1, 2, 3, 0),
                    flow_b_np.transpose(1, 2, 3, 0), *nl)
                gx, gy = gx.transpose(3, 0, 1, 2), gy.transpose(3, 0, 1, 2)
                mask_tofill = mask_tofill.transpose(2, 0, 1)
        with stage(timer, "s5_poisson"):
            mask_tofill = np.stack([scipy.ndimage.binary_fill_holes(m)
                                    for m in mask_tofill])
            mask_cur = mask.copy()
            blends = []   # f64 where Poisson ran, as the JAX pipeline keeps
            for i in range(n):
                if mask_cur[i].any():
                    blend, unfilled = poisson_blend(
                        video[i], gx[i][:, :img_w - 1], gy[i][:img_h - 1],
                        mask_cur[i], mask_tofill[i])
                    blends.append(np.clip(blend, 0, 1.0))
                    mask_cur[i] = unfilled
                else:
                    blends.append(video[i])
            logger.info("poisson blending done; %d px left for FGT",
                        int(mask_cur.sum()))
        if "prop" in vis:
            save_prop(vis_root, blends, mask_cur)

        with stage(timer, "s6_fgt"):
            if exact_windows:
                comp = fgt_synthesis_exact(
                    models, np.stack(blends),
                    torch.from_numpy(mask_cur.astype(np.uint8)).to(dev),
                    comp_f, neighbor_stride, step, num_ref)
            else:
                comp = fgt_synthesis(
                    models, torch.from_numpy(to_u8(np.stack(blends) * 255.0)
                                             ).to(dev),
                    torch.from_numpy(mask_cur.astype(np.uint8)).to(dev),
                    comp_f, neighbor_stride, step, num_ref, window_batch,
                    backoffs)
            out = comp.cpu().numpy()
    if backoffs:
        logger.warning("OOM backoffs: %s", backoffs)
    return out


# ---------------- debug outputs ----------------

VIS = ("flows", "completed_flows", "prop")


def _imwrite_as_cv2(path: str, img: np.ndarray) -> None:
    """A PNG holding what ``cv2.imwrite(path, img)`` writes for a float
    [H, W] or RGB [H, W, 3] array: values rounded to nearest (ties to
    even) and saturated to uint8, the channels read as BGR (so the file
    holds them reversed)."""
    u8 = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    image_io.write_png(path, u8[..., ::-1] if u8.ndim == 3 else u8)


def save_prop(outroot: str, frame_blends, masks_left) -> None:
    """Stage-I (propagation + Poisson) outputs: a PNG and an ``.npy`` per
    frame of the blends (·255) and of the pixels left for FGT, in the
    JAX CLI's ``_save_prop`` directories (reference save_fgcp,
    tool/video_inpainting.py:157-177); the PNGs decode to what its
    ``cv2.imwrite`` calls write."""
    dirs = {n: os.path.join(outroot, n) for n in
            ("prop_frames", "masks_left", "prop_frames_npy",
             "masks_left_npy")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i, frame in enumerate(frame_blends):
        m = masks_left[i].astype(np.float32)
        _imwrite_as_cv2(os.path.join(dirs["prop_frames"], f"{i:05d}.png"),
                        frame * 255.0)
        _imwrite_as_cv2(os.path.join(dirs["masks_left"], f"{i:05d}.png"),
                        m * 255.0)
        np.save(os.path.join(dirs["prop_frames_npy"], f"{i:05d}.npy"),
                frame * 255.0)
        np.save(os.path.join(dirs["masks_left_npy"], f"{i:05d}.npy"),
                m * 255.0)


def save_flows(outroot: str, flow_f: np.ndarray, flow_b: np.ndarray,
               subdir: str = "completed_flow") -> None:
    """``.flo`` files and flow-colour PNGs per direction, in the JAX
    CLI's ``_save_flows`` directories (reference save_flows,
    tool/video_inpainting.py:120-155; s1's flows go under ``flow/``)."""
    for name, flows in (("forward", flow_f), ("backward", flow_b)):
        flo_dir = os.path.join(outroot, subdir, f"{name}_flo")
        png_dir = os.path.join(outroot, subdir, f"{name}_png")
        os.makedirs(flo_dir, exist_ok=True)
        os.makedirs(png_dir, exist_ok=True)
        for i in range(flows.shape[0]):
            flow_io.write_flow(flows[i], os.path.join(flo_dir, f"{i:05d}.flo"))
            image_io.write_png(os.path.join(png_dir, f"{i:05d}.png"),
                               (flow_viz.flow_to_rgb(flows[i]) * 255
                                ).astype(np.uint8))


# ---------------- CLI ----------------

WEIGHT_SUFFIXES = (".pth", ".pth.tar", ".tar")


def _load_ckpt_dir(path: Optional[str], default_cfg: dict):
    """(config, state) from a checkpoint directory, defaults when it is
    absent; ``default_cfg`` (:data:`DEFAULT_LAFC_CONFIG` or
    :data:`DEFAULT_FGT_CONFIG`) says which model, LAFC or FGT. The
    directory is laid out as the JAX package writes one (``<kind>.msgpack`` or
    ``model.msgpack`` and a ``config.yaml``), as the reference ships one
    (one weights file such as ``fgt.pth.tar`` and the ``.yaml`` training
    config it came from) or as the port writes one (``model.pth`` and
    ``config.json``). Weights are the ``*.msgpack`` flax tree (it wins, as
    the JAX CLI's ``find_model_pair`` takes it first; a tree that does
    not match the configured model raises), else the ``*.pth``,
    ``*.pth.tar`` or ``*.tar`` state dict (reference key names); the
    config is the directory's ``*.yaml``, read as the JAX CLI reads it
    (it wins over a ``config.json`` beside it), else ``config.json``."""
    config, state = dict(default_cfg), None
    if path and os.path.isdir(path):
        names = sorted(os.listdir(path))
        yamls = [f for f in names if f.endswith(".yaml")]
        if yamls:
            config.update(read_flat_yaml(os.path.join(path, yamls[0])))
        elif "config.json" in names:
            with open(os.path.join(path, "config.json")) as f:
                config.update(json.load(f))
        packed = [f for f in names if f.endswith(".msgpack")]
        weights = [f for f in names if f.endswith(WEIGHT_SUFFIXES)]
        if packed or weights:
            kind = "fgt" if default_cfg["model"] == "model" else "lafc"
            state = load_weights(os.path.join(
                path, packed[0] if packed else weights[-1]), kind, config)
    return config, state


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags that apply to the port."""
    p = argparse.ArgumentParser()
    p.add_argument("--opt", default=None,
                   help="YAML file whose top-level keys override the flags "
                        "(only keys the parser has)")
    p.add_argument("--mode", default="object_removal", choices=MODES)
    p.add_argument("--path", default="data/frames",
                   help=".npy stack or directory of *.png / *.jpg frames "
                        "(baseline, progressive or multi-scan JPEG, Huffman- "
                        "or arithmetic-coded, gray, YCbCr, RGB, CMYK or "
                        "YCCK, any integral sampling; not lossless or "
                        "12-bit; read as cv2.imread reads them, EXIF "
                        "orientation applied)")
    p.add_argument("--path_mask", default="data/masks",
                   help=".npy stack or directory of *.png / *.jpg masks")
    p.add_argument("--outroot", default="out")
    p.add_argument("--consistencyThres", type=float, default=5)
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--Nonlocal", type=bool, default=False,
                   help="add flowNN candidates from the key frames "
                        "[0, N//2, N-1] (flows on the all-pairs pyramid); "
                        "parsed as the JAX and reference CLIs parse it "
                        "(type=bool): any nonempty value, 'False' too, "
                        "turns it on")
    p.add_argument("--raft_model", default="checkpoints/raft/raft.msgpack",
                   help="reference RAFT state dict, or the JAX package's "
                        "raft.msgpack (--small: RAFT small's); random init "
                        "if absent")
    p.add_argument("--small", action="store_true",
                   help="RAFT's small variant (hidden 96, context 64, "
                        "radius 3)")
    p.add_argument("--mixed_precision", action="store_true",
                   help="accepted for the reference CLI's sake; the dtype "
                        "is --bf16 / --f32")
    p.add_argument("--alternate_corr", action="store_true",
                   help="s1 and s3b correlation as the reference's "
                        "AlternateCorrBlock: kernel K1 in f32 on pooled "
                        "features (wins over --fused_corr)")
    p.add_argument("--lafc_ckpts", default="checkpoints/lafc",
                   help="directory with a .msgpack (the JAX package's) or "
                        ".pth/.pth.tar weights file and a .yaml or "
                        "config.json config")
    p.add_argument("--fgt_ckpts", default="checkpoints/fgt",
                   help="directory with a .msgpack (the JAX package's) or "
                        ".pth/.pth.tar weights file and a .yaml or "
                        "config.json config")
    p.add_argument("--H_scale", type=float, default=2,
                   help="video extrapolation: canvas height / frame height")
    p.add_argument("--W_scale", type=float, default=2,
                   help="video extrapolation: canvas width / frame width")
    p.add_argument("--imgH", type=int, default=256)
    p.add_argument("--imgW", type=int, default=432)
    p.add_argument("--flow_mask_dilates", type=int, default=8)
    p.add_argument("--frame_dilates", type=int, default=0)
    p.add_argument("--step", type=int, default=10)
    p.add_argument("--num_ref", type=int, default=-1)
    p.add_argument("--neighbor_stride", type=int, default=5)
    p.add_argument("--raft_chunk", type=int, default=None)
    p.add_argument("--raft_iters", type=int, default=20)
    p.add_argument("--lafc_chunk", type=int, default=None)
    p.add_argument("--window_batch", type=int, default=None)
    p.add_argument("--exact_windows", action="store_true",
                   help="reproduce the reference's per-window shapes "
                        "exactly (one forward per window, on the float "
                        "Poisson frames)")
    p.add_argument("--host_diffusion", action="store_true",
                   help="run the s2 regionfill diffusion on the host "
                        "(native multigrid) instead of the device's "
                        "preconditioned CG")
    p.add_argument("--fused_corr", choices=["auto", "on", "off"],
                   default="auto",
                   help="s1 correlation: auto/on = kernel K1 on pooled "
                        "features, off = the all-pairs pyramid (kernel K3)")
    p.add_argument("--pallas_lookup", choices=["auto", "on", "off"],
                   default="auto",
                   help="accepted for the JAX CLI's sake: on the card the "
                        "pyramid lookup is always kernel K3")
    p.add_argument("--corr_f32", action="store_true",
                   help="keep the all-pairs pyramid in f32 under bf16")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bfloat16 weights and activations (default)")
    p.add_argument("--f32", dest="bf16", action="store_false",
                   help="float32 inference")
    p.add_argument("--vis_flows", action="store_true",
                   help="write s1's flows (.flo + PNG) under flow/")
    p.add_argument("--vis_completed_flows", action="store_true",
                   help="write s2's completed flows under completed_flow/")
    p.add_argument("--vis_prop", action="store_true",
                   help="write the Poisson frames and the pixels left for "
                        "FGT (prop_frames/, masks_left/, and their .npy)")
    p.add_argument("--vis_frame", action="store_true",
                   help="accepted for the JAX CLI's sake: the output frames "
                        "are always written as frames/NNNNN.png")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace (trace.json) of the "
                        "run and its spans' records (spans.jsonl) to this "
                        "directory")
    p.add_argument("--dp", action="store_true",
                   help="shard batched stage calls over the ranks of the "
                        "process group (multi-GPU serving, one process a "
                        "card: torchrun or a group the caller made)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: Megatron-shard the FGT "
                        "attention heads / FFN hidden over tp ranks "
                        "(combines with --dp; ranks = dp*tp)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: Ulysses-shard the FGT "
                        "folded temporal frame axis over sp ranks "
                        "(head-scatter all-to-alls inside TMHSA; "
                        "ranks = dp*tp*sp)")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init of models without weights")
    return p


def build_models(args) -> Models:
    """:class:`Models` from the CLI's checkpoint flags (random init from
    ``--seed`` for any model without weights)."""
    lafc_cfg, lafc_state = _load_ckpt_dir(args.lafc_ckpts, DEFAULT_LAFC_CONFIG)
    fgt_cfg, fgt_state = _load_ckpt_dir(args.fgt_ckpts, DEFAULT_FGT_CONFIG)
    raft_state = (load_weights(args.raft_model,
                               "raft_small" if args.small else "raft")
                  if os.path.exists(args.raft_model) else None)
    corr = ("alternate" if args.alternate_corr else
            "pyramid" if args.fused_corr == "off" else "fused")
    for name, st in (("RAFT", raft_state), ("LAFC", lafc_state),
                     ("FGT", fgt_state)):
        if st is None:
            logger.warning("%s weights not found; random init (seed %d)",
                           name, args.seed)
    tp, sp = int(getattr(args, "tp", 1) or 1), int(getattr(args, "sp", 1) or 1)
    mesh = (make_mesh(tp=tp, sp=sp)
            if (getattr(args, "dp", False) or tp > 1 or sp > 1)
            and dist.world_size() > 1 else None)
    return Models(args.device, args.bf16, args.raft_iters, lafc_cfg, fgt_cfg,
                  args.seed, raft_state, lafc_state, fgt_state, corr=corr,
                  corr_f32=args.corr_f32, small=args.small, mesh=mesh)


def load_frames(path: str, img_h: int, img_w: int,
                premask_path: Optional[str] = None):
    """Frames as the JAX loader makes them, one at a time: RGB at its
    source size (PNG or JPEG, EXIF orientation applied as its
    ``cv2.imread``), premasked there when ``premask_path`` is given
    (watermark removal), then float cv2-INTER_LINEAR resized to
    img_h x img_w. Returns (float32 [N, img_h, img_w, 3] in [0, 255],
    the last frame's source (H, W))."""
    frames = image_io.read_frames(path, image_io.CLI_MODE)
    holes = (image_io.read_frames(premask_path, image_io.CLI_MODE)
             if premask_path is not None else None)
    if holes is not None and len(holes) != len(frames):
        raise ValueError(f"{len(frames)} frames but {len(holes)} masks")
    out = []
    for i, frame in enumerate(frames):
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        frame = frame[..., :3].astype(np.float32)
        if holes is not None:
            hole = holes[i][..., 0] if holes[i].ndim == 3 else holes[i]
            frame = frame * (1 - (hole > 0).astype(np.float32)[..., None])
        out.append(image_io.resize_linear(frame[None], img_h, img_w)[0])
    return np.stack(out), frame.shape[:2]


def load_masks(path: str, img_h: int, img_w: int) -> np.ndarray:
    """[N, img_h, img_w] masks (channel 0 of PNG or JPEG files, EXIF
    orientation applied), each nearest-resized from its own size."""
    return np.stack([
        image_io.resize_nearest((m[..., 0] if m.ndim == 3 else m)[None],
                                img_h, img_w)[0]
        for m in image_io.read_frames(path, image_io.CLI_MODE)])


def video_inpainting(args, models: Optional[Models] = None) -> str:
    """Run the CLI pipeline; returns the path of ``result.npy``, written
    beside ``result.mp4`` (H.264 I_PCM at 30 fps, ``core/video_io.py``,
    where the JAX CLI writes its own) and the PNG frames. Pass a
    resident ``models`` to serve many videos (the batch driver)."""
    timer = StageTimer(torch.device(args.device))
    backoffs: list = []
    with stage(timer, "s0_init"):
        if models is None:
            models = build_models(args)
    out = inpaint_from_args(args, models, timer, backoffs)
    if dist.rank() == 0:
        with stage(timer, "s7_write"):
            image_io.write_frames(args.outroot, out)
            video_io.write_video(os.path.join(args.outroot, "result.mp4"),
                                 out, fps=30)
    n = out.shape[0]
    total = timer.total()
    logger.info("stages %s; %d frames in %.2f s (%.2f frames/s)",
                {k: round(v, 3) for k, v in timer.times.items()}, n, total,
                n / total if total else math.inf)
    if dist.rank() == 0:
        timer.dump(os.path.join(args.outroot, "timings.jsonl"), n_frames=n,
                   mode=args.mode, backoffs=[list(b) for b in backoffs])
    return os.path.join(args.outroot, "result.npy")


def inpaint_from_args(args, models: Models,
                      timer: Optional[StageTimer] = None,
                      backoffs: Optional[list] = None) -> np.ndarray:
    """The CLI's frames and masks (``--path``, ``--path_mask``) through
    :func:`inpaint` with the CLI's options. Every rank of a mesh returns
    the output frames; :func:`video_inpainting` writes them from rank 0."""
    timer = timer or StageTimer(torch.device(args.device))
    with stage(timer, "s0_load_frames"):
        frames, src_hw = load_frames(
            args.path, args.imgH, args.imgW,
            args.path_mask if args.mode == "watermark_removal" else None)
        masks = (None if args.mode == "video_extrapolation"
                 else load_masks(args.path_mask, args.imgH, args.imgW))
    return inpaint(frames, masks, models, mode=args.mode,
                   h_scale=args.H_scale, w_scale=args.W_scale,
                   use_nonlocal=bool(args.Nonlocal),
                   flow_mask_dilates=args.flow_mask_dilates,
                   frame_dilates=args.frame_dilates,
                   consistency_thres=args.consistencyThres, alpha=args.alpha,
                   neighbor_stride=args.neighbor_stride, step=args.step,
                   num_ref=args.num_ref, raft_chunk=args.raft_chunk,
                   lafc_chunk=args.lafc_chunk, window_batch=args.window_batch,
                   host_upscale=tuple(src_hw) != (args.imgH, args.imgW),
                   timer=timer, vis_root=args.outroot,
                   vis=tuple(v for v in VIS if getattr(args, f"vis_{v}")),
                   exact_windows=args.exact_windows,
                   host_diffusion=args.host_diffusion, backoffs=backoffs)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    args = apply_yaml_over_args(args, args.opt)
    had_group = dist.initialized()
    args.device = dist.init_from_flags(device=args.device)
    try:
        profile = args.profile if dist.rank() == 0 else ""
        with maybe_trace(profile, torch.device(args.device)):
            return video_inpainting(args)
    finally:
        if not had_group:
            dist.shutdown()


if __name__ == "__main__":
    main()
