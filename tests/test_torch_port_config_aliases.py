"""The port's model configs against the JAX package's ``from_dict``s, on
the CPU:

* every alias key (``pass_mask``, ``res_blocks``, ``flow_in_channel``,
  ``num_blocks``, ``num_heads``, the pair keys ``kernel_size``,
  ``stride``, ``padding``), alone and beside the reference name it loses
  to, builds the module the JAX config describes: the JAX module's
  parameter shapes (``jax.eval_shape`` of its init, moved through the
  weight tables) load strictly into the port's module, the parameter
  counts are equal, and the fields that shape no parameter (heads,
  stride, padding) are equal;
* a gated or partial ``conv_type``, or a ``norm`` naming a layer, raises
  a ValueError naming the key and its value in every model builder, the
  training CLI, the FGT trainer's flow oracle and the inference CLI's
  checkpoint loader; an integer ``norm`` (the training CLI's data flag)
  names no layer and builds.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.models.fgt import FGTConfig as JaxFGTConfig
from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.models.lafc import LAFCConfig as JaxLAFCConfig
from fgt_tpu.models.lafc import Model as JaxLAFC
from fgt_tpu.models.lafc_single import Model as JaxLAFCSingle
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc as tlafc
from fgt_tpu_torch.models import lafc_single as tlafc_single
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from fgt_tpu_torch.train import train as train_cli
from fgt_tpu_torch.utils.config import dump_yaml

LAFC = {"cnum": 8, "num_flows": 3, "use_bias": 1, "use_residual": 1}
FGT = {"cnum": 8, "flow_cnum": 8, "frame_hidden": 32, "flow_hidden": 16,
       "mlp_ratio": 2, "tw": 2, "sw": 4, "gd": 2, "numBlocks": 4,
       "num_head": 4, "in_channel": 4}

LAFC_CASES = [
    {"pass_mask": 0, "in_channel": 2},
    {"res_blocks": 3},
    {"PASSMASK": 1, "pass_mask": 0},
    {"resBlocks": 2, "res_blocks": 3},
    {"PASSMASK": 0, "pass_mask": 1, "in_channel": 2, "res_blocks": 2},
]
FGT_CASES = [
    {"num_blocks": 2, "num_heads": 2, "pass_mask": 0, "in_channel": 3,
     "numBlocks": None, "num_head": None},
    {"numBlocks": 4, "num_blocks": 2},
    {"num_head": 2, "num_heads": 4},
    {"PASSMASK": 1, "pass_mask": 0},
    {"flow_in_channel": 3},
    {"flow_inChannel": 2, "flow_in_channel": 3},
    {"kernel_size": [5, 5], "kernel_size_h": 7, "kernel_size_w": 7},
    {"stride": [2, 2], "padding": [2, 2], "stride_h": 3, "pad_h": 3},
    {"kernel_size": [], "kernel_size_h": 5, "kernel_size_w": 3,
     "stride": 0, "stride_h": 2, "padding": None, "pad_w": 1},
]


def _cfg(base, case):
    """``base`` overridden by ``case``; a None in ``case`` drops the key
    (so the alias alone is read)."""
    cfg = dict(base, **case)
    return {k: v for k, v in cfg.items() if v is not None}


def _load_shapes(port, jax_module, mapping, *inputs):
    """Load zeros of the JAX module's parameter shapes into ``port``
    through ``mapping`` (strict: keys and shapes must match); returns the
    JAX parameter count."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *inputs)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    weights.load_state(port, weights.jax_to_torch_state(zeros, mapping))
    return sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes["params"]))


def _count(module):
    return sum(p.numel() for p in module.parameters())


@pytest.mark.parametrize("model,case", [("lafc", c) for c in LAFC_CASES]
                         + [("lafc_single", c) for c in LAFC_CASES[:3]]
                         + [("fgt", c) for c in FGT_CASES])
def test_alias_builds_the_jax_module(model, case):
    """Exact: equal shapes, equal parameter counts, equal fields."""
    if model == "fgt":
        cfg = _cfg(FGT, case)
        jcfg = JaxFGTConfig.from_dict(cfg)
        port = tfgt.Model(cfg)
        c = port.net.cfg
        for field in ("in_channel", "flow_in_channel", "num_blocks",
                      "num_heads", "pass_mask", "kernel_size", "stride",
                      "padding"):
            assert getattr(c, field) == getattr(jcfg, field), field
        assert port.net.patch2vec.stride == tuple(jcfg.stride)
        assert port.net.patch2vec.padding == tuple(jcfg.padding)
        assert port.net.first_t_transformer.attention.num_heads == \
            jcfg.num_heads
        t, h, w = 2, 64, 64
        n = _load_shapes(port, JaxFGT(config=cfg),
                         weights.fgt_mapping(jcfg.num_blocks),
                         jnp.zeros((1, t, h, w, 3)),
                         jnp.zeros((1, t, h, w, jcfg.flow_in_channel)),
                         jnp.zeros((1, t, h, w, 1)))
    else:
        cfg = _cfg(LAFC, case)
        jcfg = JaxLAFCConfig.from_dict(cfg)
        keys = tlafc.lafc_keys(cfg)
        assert (keys["pass_mask"], keys["res_blocks"]) == \
            (jcfg.pass_mask, jcfg.res_blocks)
        if model == "lafc":
            port, jm = tlafc.Model(cfg), JaxLAFC(config=cfg)
            mapping = weights.lafc_mapping(jcfg.res_blocks)
            inputs = (jnp.zeros((1, 3, 32, 32, 2)),
                      jnp.zeros((1, 3, 32, 32, 1)))
        else:
            port, jm = tlafc_single.Model(cfg), JaxLAFCSingle(config=cfg)
            mapping = weights.lafc_single_mapping(jcfg.res_blocks)
            inputs = (jnp.zeros((1, 32, 32, 2)), jnp.zeros((1, 32, 32, 1)))
        assert port.net.pass_mask == jcfg.pass_mask
        n = _load_shapes(port, jm, mapping, *inputs)
    assert _count(port) == n


BUILDERS = {"lafc": (tlafc.Model, LAFC), "lafc_single":
            (tlafc_single.Model, LAFC), "fgt": (tfgt.Model, FGT)}
REFUSED = [("conv_type", "gated"), ("conv_type", "partial"),
           ("norm", "BN"), ("norm", "IN"), ("norm", "SN")]


@pytest.mark.parametrize("model", sorted(BUILDERS))
@pytest.mark.parametrize("key,value", REFUSED)
def test_builder_refuses_what_the_port_lacks(model, key, value):
    build, base = BUILDERS[model]
    with pytest.raises(ValueError, match=f"{key}={value!r}"):
        build(dict(base, **{key: value}))


@pytest.mark.parametrize("model", sorted(BUILDERS))
@pytest.mark.parametrize("norm", [None, "None", "none", 0, 1])
def test_builder_takes_no_norm(model, norm):
    build, base = BUILDERS[model]
    build(dict(base, norm=norm, conv_type="vanilla"))


def test_training_cli_refuses_gated(tmp_path):
    """``--conv_type gated`` through the CLI's parser, for each trainer;
    and FGT's flow oracle from a ``flow_config`` that says partial."""
    for model in ("lafc", "lafc_single", "model"):
        with pytest.raises(ValueError, match="conv_type='gated'"):
            train_cli.main(["--model", model, "--conv_type", "gated",
                            "--name", model, "--outputdir", str(tmp_path),
                            "--device", "cpu",
                            "--cnum", "8", "--frame_hidden", "32",
                            "--flow_hidden", "16", "--flow_cnum", "8",
                            "--numBlocks", "2", "--mlp_ratio", "2"])
    opt = tmp_path / "fgt.yaml"
    opt.write_text(dump_yaml({
        "cnum": 8, "flow_cnum": 8, "frame_hidden": 32, "flow_hidden": 16,
        "numBlocks": 2, "mlp_ratio": 2, "outputdir": str(tmp_path),
        "flow_checkPoint": str(tmp_path / "absent.pth"),
        "flow_config": {"cnum": 8, "conv_type": "partial"}}))
    with pytest.raises(ValueError, match="LAFC-single: conv_type='partial'"):
        train_cli.main(["--model", "model", "--opt", str(opt),
                        "--device", "cpu"])


@pytest.mark.parametrize("stage", ["lafc", "fgt"])
def test_checkpoint_with_gated_config_refuses_to_load(tmp_path, stage):
    """A port checkpoint directory whose config.json says gated never
    loads into a vanilla net: the inference CLI's model build raises."""
    build, base = BUILDERS[stage]
    ck = tmp_path / stage
    ck.mkdir()
    torch.save(build(base).state_dict(), ck / "model.pth")
    with open(ck / "config.json", "w") as f:
        json.dump(dict(base, conv_type="gated"), f)
    args = tvi.build_parser().parse_args([
        f"--{stage}_ckpts", str(ck), "--raft_model",
        os.path.join(str(tmp_path), "absent.pth"), "--device", "cpu",
        "--small", "--f32"])
    with pytest.raises(ValueError, match="conv_type='gated'"):
        tvi.build_models(args)
