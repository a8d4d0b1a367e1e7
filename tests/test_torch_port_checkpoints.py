"""Checkpoint directories as the reference ships them, read by the port's
CLI, against the JAX CLI, on the CPU, in f32:

* a directory holding a reference-keyed ``fgt.pth.tar`` / ``lafc.pth.tar``
  state dict (the JAX package's tiny model moved through the weight
  bridge) and the ``config.yaml`` of a training run (nested ``datasets:``
  and ``train:`` blocks, a flow map, comments): the port builds the
  architecture the JAX CLI builds from the same YAML, loads the weights,
  and its model's output matches the JAX model's at the module tests'
  tolerance; the YAML wins over a ``config.json`` beside it, as the JAX
  CLI reads only the YAML;
* ``read_flat_yaml`` (no PyYAML on the GPU machine) equals
  ``yaml.safe_load`` on the top-level scalar and flow-list keys of every
  ``configs/*.yaml`` and of a file of YAML's scalar forms, and raises on
  what it cannot read.
"""

import argparse
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from fgt_tpu_torch.utils.config import read_flat_yaml

torch.set_num_threads(1)

CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "*.yaml")))

# the tail every reference training config carries: blocks no model
# builder reads
TRAINING_BLOCKS = """\
datasets:
  dataInfo:
    frame_path: data/youtubevos_frames
    name2len: ~            # pickle path
    flow: {flow_height: 240, flow_width: 432}
  train: {batch_size: 2, n_workers: 4}
train:
  lr: 0.0001
  WARMUP: ~
flow_config: {cnum: 48, in_channel: 3, PASSMASK: 1,
              resBlocks: 1, conv_type: vanilla}
"""

REFERENCE_YAML = {
    "fgt": """\
### FGT stage-2 training (cut to a tiny width)
name: FGT_train
model: model
seed: 10
""" + TRAINING_BLOCKS + """\
input_resolution: [64, 64]
res_h: 64
res_w: 64
in_channel: 4
cnum: 8
flow_inChannel: 2
flow_cnum: 8
frame_hidden: 32
flow_hidden: 16
PASSMASK: 1
numBlocks: 2
kernel_size_w: 7
kernel_size_h: 7
stride_h: 3
stride_w: 3
pad_h: 3
pad_w: 3
num_head: 4
conv_type: vanilla
norm: ~
use_bias: 1
ape: 1
mlp_ratio: 2
drop: 0
tw: 2
sw: 4
gd: 2
""",
    "lafc": """\
name: LAFC_train
model: lafc
""" + TRAINING_BLOCKS + """\
num_flows: 3
flow_interval: 3
sample: seq
use_edges: 0
input_resolution: [64, 64]   # trailing comment
PASSMASK: 1
use_bias: 1
cnum: 8
in_channel: 3
conv_type: vanilla
use_residual: 1
resBlocks: 1
""",
}


def _jax_cli_model(ckpt_dir, kind):
    """The JAX CLI's own loader (``Models._load``) on ``ckpt_dir``:
    (flax module, variables, config)."""
    shell = jvi.Models.__new__(jvi.Models)
    default = (jvi.DEFAULT_FGT_CONFIG if kind == "fgt"
               else jvi.DEFAULT_LAFC_CONFIG)
    config = shell._load(argparse.Namespace(**{f"{kind}_ckpts": ckpt_dir}),
                         f"{kind}_ckpts", default, kind)
    return (getattr(shell, f"{kind}_model"),
            jax.tree_util.tree_map(np.asarray, getattr(shell, f"{kind}_vars")),
            config)


@pytest.mark.parametrize("kind", ["fgt", "lafc"])
def test_reference_checkpoint_dir_matches_jax_cli(tmp_path, kind):
    """``<kind>.pth.tar`` (a ``state_dict`` container with DataParallel
    ``module.`` keys, as the reference saves it) + ``config.yaml`` + a
    ``config.json`` naming another width: the port's CLI models get the
    YAML's architecture and the file's weights. Tolerances as in the
    module tests: FGT 1e-4 on the tanh output, LAFC 1e-4 of the flow
    scale (f32 reassociation)."""
    ckpt = tmp_path / kind
    ckpt.mkdir()
    (ckpt / "config.yaml").write_text(REFERENCE_YAML[kind])
    (ckpt / "config.json").write_text(json.dumps({"cnum": 64,
                                                  "numBlocks": 8}))
    model, variables, jax_cfg = _jax_cli_model(str(ckpt), kind)
    mapping = (weights.fgt_mapping(2) if kind == "fgt"
               else weights.lafc_mapping(1))
    state = weights.jax_to_torch_state(variables, mapping)
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}},
               ckpt / f"{kind}.pth.tar")

    args = tvi.build_parser().parse_args([
        f"--{kind}_ckpts", str(ckpt), "--raft_model", "/nonexistent",
        "--f32", "--device", "cpu", "--raft_iters", "1"])
    models = tvi.build_models(args)
    port_cfg = models.fgt_config if kind == "fgt" else models.lafc_config
    for key in ("cnum", "numBlocks", "frame_hidden", "num_flows"):
        assert port_cfg.get(key) == jax_cfg.get(key), key
    assert port_cfg["cnum"] == 8
    rng = np.random.RandomState(7)
    if kind == "fgt":
        shape = (1, 5, 64, 64)
        frames = rng.uniform(-1, 1, shape + (3,)).astype(np.float32)
        flows = rng.randn(*shape, 2).astype(np.float32)
        masks = (rng.rand(*shape, 1) > 0.8).astype(np.float32)
        want = np.asarray(model.apply(variables, jnp.asarray(frames),
                                      jnp.asarray(flows), jnp.asarray(masks)))
        with torch.no_grad():
            got = models.fgt(*(torch.from_numpy(a) for a in
                               (frames, flows, masks))).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
    else:
        flows = (rng.randn(2, 3, 32, 48, 2) * 4).astype(np.float32)
        masks = (rng.rand(2, 3, 32, 48, 1) > 0.7).astype(np.float32)
        want = np.asarray(model.apply(variables, jnp.asarray(flows),
                                      jnp.asarray(masks))[0])
        with torch.no_grad():
            got = models.lafc(torch.from_numpy(flows),
                              torch.from_numpy(masks))[0].numpy()
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_config_json_alone_and_missing_weights(tmp_path):
    """A directory with only ``config.json`` (the port's own layout) still
    configures the model; with no weights file the state stays None (the
    CLI then warns and random-initializes, as the JAX CLI does)."""
    (tmp_path / "config.json").write_text(json.dumps({"cnum": 16}))
    config, state = tvi._load_ckpt_dir(str(tmp_path),
                                       tvi.DEFAULT_LAFC_CONFIG)
    assert config["cnum"] == 16 and state is None
    config, state = tvi._load_ckpt_dir(str(tmp_path / "absent"),
                                       tvi.DEFAULT_LAFC_CONFIG)
    assert config == tvi.DEFAULT_LAFC_CONFIG and state is None


def _flat(loaded: dict) -> dict:
    return {k: v for k, v in loaded.items() if not isinstance(v, dict)}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_read_flat_yaml_matches_pyyaml_on_configs(path):
    with open(path) as f:
        want = _flat(yaml.safe_load(f))
    assert read_flat_yaml(path) == want


SCALARS = """\
---
# a comment line
a: 1 # after a value
b: 0.0001
c: 1e-4
d: 'it''s'
e: "q\\"x"
f: [240, 432]
g: ~
h:
i: yes
j: 1_000
k: .5
l: -.inf
m: [a, 'b c', 1.5,
    2]
n: 0x1F
o: text with # hash
q:
  nested: 1
r: 1.0e+3
s: +3
u: 3.
v: "1"
w: []
"""


@pytest.mark.parametrize("text,expect", [
    (SCALARS, None), (REFERENCE_YAML["fgt"], None),
    ("x: &anchor 1\n", ValueError), ("- 1\n", ValueError),
    ("x: 0755\n", ValueError), ("x: |\n  block\n", ValueError),
    ("x: [1, [2]]\n", ValueError)])
def test_read_flat_yaml_scalar_forms(tmp_path, text, expect):
    """YAML 1.1's scalar forms as PyYAML resolves them (``1e-4`` has no
    dot, so it is a string; ``yes`` is true); anchors, block sequences,
    octal, block scalars and nested lists raise."""
    path = tmp_path / "c.yaml"
    path.write_text(text)
    if expect is ValueError:
        with pytest.raises(ValueError):
            read_flat_yaml(str(path))
    else:
        assert read_flat_yaml(str(path)) == _flat(yaml.safe_load(text))
