"""Model registry — counterpart of ``fgt_tpu/models/registry.py``: maps
the reference's YAML ``model:`` keys to the port's ``nn.Module`` classes.

The reference selects model classes dynamically via
``import_module('models.<name>')`` from the yaml that travels with each
checkpoint (tool/video_inpainting.py:200-230); this registry is the
explicit equivalent. Each entry imports its module only when asked.
"""

from __future__ import annotations


def _fgt():
    from fgt_tpu_torch.models import fgt

    return fgt.Model


def _lafc():
    from fgt_tpu_torch.models import lafc

    return lafc.Model


def _lafc_single():
    from fgt_tpu_torch.models import lafc_single

    return lafc_single.Model


MODELS = {
    "model": _fgt,          # the reference FGT yaml uses model: model
    "fgt": _fgt,
    "lafc": _lafc,
    "lafc_single": _lafc_single,
}


def build_model(name: str, config: dict):
    if name not in MODELS:
        raise KeyError(f"unknown model '{name}'; known: {sorted(MODELS)}")
    cls = MODELS[name]()
    return cls(config=config)
