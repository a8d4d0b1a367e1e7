"""On-demand ``torch.profiler`` traces — the port's counterpart of
``fgt_tpu/utils/profiling.py``.

    with maybe_trace("/tmp/fgt_trace", torch.device("cuda")):
        ... run stages ...

writes ``/tmp/fgt_trace/trace.json`` (Chrome trace format: Perfetto or
chrome://tracing). Unlike the JAX package's, a trace that cannot be
taken raises: a run asked to profile does not go on unprofiled.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch
from torch.profiler import ProfilerActivity, profile

logger = logging.getLogger("fgt_tpu_torch")


@contextlib.contextmanager
def maybe_trace(log_dir: str | None, device: torch.device | None = None):
    """Trace the host and, on a CUDA ``device``, the card's kernels
    inside the block into ``log_dir/trace.json``; no-op without a
    ``log_dir``."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace -> %s", path)
