"""Checkpoint I/O — counterpart of ``fgt_tpu/utils/checkpoint.py``.

Weights are ``state_dict``s keyed by the reference module names, written
with ``torch.save`` and read with ``torch.load(weights_only=True)``, so a
reference ``.pth`` / ``.pth.tar`` loads the same way. The port writes a
model directory as one ``model.pth`` and a ``config.json``; its inference
CLI also reads the reference's layout, a weights file beside the run's
``.yaml`` (``pipeline/video_inpainting._load_ckpt_dir``). Training keeps
the reference's gen / dis / opt trio (FGT/networks/network.py:225-256).

The JAX package's weight files are flax msgpack trees;
:func:`load_pytree` / :func:`save_pytree` read and write them as nested
dicts of arrays (``utils/msgpack.py``), the counterparts of
``fgt_tpu/utils/checkpoint.py``'s without a template, and
``convert/weights.state_from_variables`` turns one into a model's
``state_dict``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

import torch

from fgt_tpu_torch.utils import msgpack


def save(obj: Any, path: str, writer: Callable = torch.save) -> None:
    """``writer(obj, tmp)`` (``torch.save`` by default) into a temporary
    file renamed into place, so a reader never sees a half-written
    checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    writer(obj, tmp)
    os.replace(tmp, path)


def _write_bytes(data: bytes, path: str) -> None:
    with open(path, "wb") as f:
        f.write(data)


def save_pytree(tree: Any, path: str) -> None:
    """``tree`` (nested dicts of numpy arrays, bfloat16 tensors and
    scalars) as the flax msgpack the JAX package's ``save_pytree``
    writes."""
    save(msgpack.pack(tree), path, _write_bytes)


def load_pytree(path: str) -> Any:
    """The tree of the flax msgpack file at ``path``, as nested dicts of
    numpy arrays (bfloat16 leaves as ``torch.bfloat16`` tensors)."""
    with open(path, "rb") as f:
        return msgpack.unpack(f.read(), path)


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
