"""Checkpoint I/O — counterpart of ``fgt_tpu/utils/checkpoint.py``.

Weights are ``state_dict``s keyed by the reference module names, written
with ``torch.save`` and read with ``torch.load(weights_only=True)``, so a
reference ``.pth`` loads the same way. A model directory holds one
``model.pth`` and a ``config.json`` (the port's inference CLI reads that
pair; the JAX package writes msgpack + YAML, and the GPU machine has no
PyYAML). Training keeps the reference's gen / dis / opt trio
(FGT/networks/network.py:225-256).
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch


def save(obj: Any, path: str) -> None:
    """``torch.save`` through a temporary file renamed into place, so a
    reader never sees a half-written checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_dict(path: str) -> dict:
    """A model ``state_dict`` from ``path``, unwrapped from the
    reference's ``model_state_dict``/``state_dict`` containers and
    DataParallel ``module.`` prefixes."""
    state = load(path)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(state, dict) and key in state:
            state = state[key]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def save_model_dir(state: dict, config: dict, ckpt_dir: str) -> None:
    """Write the (``model.pth``, ``config.json``) pair the inference CLI
    consumes."""
    save(state, os.path.join(ckpt_dir, "model.pth"))
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=1)
