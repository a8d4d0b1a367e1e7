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
* every ``conv_type`` and ``norm`` the JAX models build, builds in the
  port, strictly loads the JAX module's variables (``state_from_variables``)
  and runs its forward as JAX does: gated, and FGT's BN / IN / SN
  (LAFC and LAFC-single ignore a ``norm``, as ``LAFCConfig`` does);
  ``conv_type: partial``, which every JAX model fails to build, raises a
  ValueError naming it in every model builder, the FGT trainer's flow
  oracle and the inference CLI's checkpoint loader; the training CLI
  trains gated (and BN) models; an integer ``norm`` (the training CLI's
  data flag) names no layer and builds.
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
from fgt_tpu_torch.utils.config import dump_yaml, read_yaml

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
JAX_MODELS = {"lafc": JaxLAFC, "lafc_single": JaxLAFCSingle, "fgt": JaxFGT}


def _jax_inputs(model, rng):
    if model == "fgt":
        shape = (1, 2, 32, 32)
        return (rng.uniform(-1, 1, shape + (3,)).astype(np.float32),
                rng.randn(*shape, 2).astype(np.float32),
                (rng.rand(*shape, 1) > 0.8).astype(np.float32))
    shape = (1, 3, 16, 16) if model == "lafc" else (1, 16, 16)
    return (rng.randn(*shape, 2).astype(np.float32),
            (rng.rand(*shape, 1) > 0.6).astype(np.float32))


def _seeded_variables(jm, inputs, rng):
    """The JAX module's variables (shapes by ``jax.eval_shape``) filled
    from ``rng``: fan-in scaled kernels, scales and BN variances about
    1, small biases and means; SN's u, v after power iterations."""
    from test_torch_port_gated import _warm_spectral

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in inputs))

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("var", "scale"):
            a = 0.5 + rng.rand(*s.shape)
        elif name in ("u", "v"):
            a = rng.randn(*s.shape)
        else:
            a = 0.1 * rng.randn(*s.shape)
        return a.astype(np.float32)
    return _warm_spectral(jax.tree_util.tree_map_with_path(fill, shapes))


@pytest.mark.parametrize("model", sorted(BUILDERS))
@pytest.mark.parametrize("key,value", REFUSED)
def test_builder_refuses_what_the_port_lacks(model, key, value):
    """The port refuses what the JAX models cannot build, and only that:
    ``conv_type: partial`` raises a ValueError naming it in the port and
    fails in the JAX model's init; gated and each norm build, load the
    JAX variables strictly and give JAX's forward (f32, 1e-4 of the
    output's scale)."""
    build, base = BUILDERS[model]
    cfg = dict(base, **{key: value})
    rng = np.random.RandomState(len(model) + len(value))
    inputs = _jax_inputs(model, rng)
    jm = JAX_MODELS[model](config=cfg)
    if value == "partial":
        with pytest.raises(ValueError, match="conv_type='partial'"):
            build(cfg)
        with pytest.raises((ValueError, TypeError)):
            jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                           *(jnp.asarray(a) for a in inputs))
        return
    variables = _seeded_variables(jm, inputs, rng)
    port = build(cfg).eval()
    kind = "fgt" if model == "fgt" else model
    weights.load_state(port, weights.state_from_variables(kind, variables,
                                                          cfg))
    args = inputs if model != "fgt" else (
        inputs[0] * (1 - inputs[2]),) + inputs[1:]
    want = jax.jit(jm.apply)(variables, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    if model != "fgt":              # (flow, edge)
        got, want = got[0], want[0]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("model", sorted(BUILDERS))
@pytest.mark.parametrize("norm", [None, "None", "none", 0, 1])
def test_builder_takes_no_norm(model, norm):
    build, base = BUILDERS[model]
    build(dict(base, norm=norm, conv_type="vanilla"))


def test_training_cli_refuses_gated(tmp_path):
    """The training CLI takes the JAX CLI's ``--conv_type gated`` and
    integer ``--norm`` (its data flag) into the same options as the JAX
    CLI; from YAMLs that say gated (FGT also ``norm: BN``, and a gated
    LAFC-single oracle) each of the three models trains a step on the
    CPU with finite losses and saves gated (and BN) weights; a
    ``flow_config`` that says partial still refuses the oracle."""
    from fgt_tpu.train import train as jtrain
    from test_torch_port_train_cli import TINY, _config, _write_tree

    for model in ("lafc", "lafc_single", "model"):
        argv = ["--model", model, "--conv_type", "gated", "--norm", "1"]
        want = jtrain.build_opt(jtrain.args_parser(argv))
        got = train_cli.build_opt(train_cli.args_parser(argv))
        assert (got["conv_type"], got["norm"]) == ("gated", 1)
        for k in want:
            assert got[k] == want[k], k
    _write_tree(tmp_path / "train", 4, 10)
    oracle = dict(TINY["model"]["flow_config"], conv_type="gated")
    for model in ("lafc_single", "lafc", "model"):
        path = _config(tmp_path, model, 1)
        cfg = read_yaml(path)
        cfg.update(conv_type="gated", use_valid=False)
        if model == "model":
            cfg.update(norm="BN", flow_config=oracle)
        with open(path, "w") as f:
            f.write(dump_yaml(cfg))
        trainer = train_cli.main(["--model", model, "--opt", path,
                                  "--datadir", str(tmp_path),
                                  "--device", "cpu"])
        with open(trainer.metrics.path) as f:
            rows = [json.loads(line) for line in f]
        assert rows and all(np.isfinite(v) for r in rows
                            for v in r.values())
        state = (trainer.gen if model == "model" else trainer.model
                 ).state_dict()
        assert any(k.endswith("gatingConv.weight") for k in state)
        assert any(k.endswith("norm_layer.running_var") for k in state) \
            == (model == "model")
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
    """A port checkpoint directory whose config.json says gated (FGT
    also BN) loads through the inference CLI's model build, its weights
    bit-equal to the saved ones; one whose config.json says partial
    raises naming it."""
    build, base = BUILDERS[stage]
    gated = dict(base, conv_type="gated",
                 **({"norm": "BN"} if stage == "fgt" else {}))
    saved = build(gated).state_dict()
    for name, cfg in (("gated", gated),
                      ("partial", dict(base, conv_type="partial"))):
        ck = tmp_path / name
        ck.mkdir()
        torch.save(saved, ck / "model.pth")
        with open(ck / "config.json", "w") as f:
            json.dump(cfg, f)
        args = tvi.build_parser().parse_args([
            f"--{stage}_ckpts", str(ck), "--raft_model",
            os.path.join(str(tmp_path), "absent.pth"), "--device", "cpu",
            "--small", "--f32"])
        if name == "partial":
            with pytest.raises(ValueError, match="conv_type='partial'"):
                tvi.build_models(args)
            continue
        models = tvi.build_models(args)
        net = models.lafc if stage == "lafc" else models.fgt
        loaded = net.state_dict()
        assert set(loaded) == set(saved)
        for k, v in saved.items():
            assert torch.equal(loaded[k].cpu(), v), k
