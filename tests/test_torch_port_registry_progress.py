"""The port's model registry (``fgt_tpu_torch.models.registry``) and
progress bars (``fgt_tpu_torch.utils.progress``) against the JAX
package's, on the CPU:

* ``MODELS`` has the JAX keys; ``build_model`` builds each key's port
  module from a config, with as many parameters as the JAX model
  initialised from the same config; LAFC-single built by name from
  both registries, with the JAX weights moved across, gives the JAX
  outputs (f32, 1e-4 of the output scale); an unknown name raises the
  JAX ``KeyError``;
* ``ProgressBar`` and ``Progbar`` write the JAX bars' exact text on a
  non-TTY stream and on a TTY stream, the clock and the terminal size
  pinned.
"""

import io
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.models import registry as jreg
from fgt_tpu.utils import progress as jprog
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.models import lafc as tlafc
from fgt_tpu_torch.models import lafc_single as tlafc_single
from fgt_tpu_torch.models import registry as treg
from fgt_tpu_torch.utils import progress as tprog

LAFC = {"num_flows": 3, "flow_interval": 3, "cnum": 8, "in_channel": 3,
        "PASSMASK": 1, "use_residual": 1, "resBlocks": 1, "use_bias": 1,
        "conv_type": "vanilla", "use_edges": 1}
FGT = {"in_channel": 4, "cnum": 8, "flow_inChannel": 2, "flow_cnum": 8,
       "frame_hidden": 32, "flow_hidden": 16, "PASSMASK": 1, "numBlocks": 2,
       "num_head": 4, "conv_type": "vanilla", "norm": None, "use_bias": 1,
       "ape": 1, "mlp_ratio": 2, "drop": 0, "tw": 2, "sw": 4, "gd": 2,
       "kernel_size_w": 7, "kernel_size_h": 7, "stride_h": 3, "stride_w": 3,
       "pad_h": 3, "pad_w": 3, "res_h": 64, "res_w": 64}
CASES = {"model": (FGT, tfgt.Model), "fgt": (FGT, tfgt.Model),
         "lafc": (LAFC, tlafc.Model),
         "lafc_single": (LAFC, tlafc_single.Model)}


def _jax_inputs(name):
    if name in ("model", "fgt"):
        shape = (1, 2, 64, 64)
        return (jnp.zeros(shape + (3,)), jnp.zeros(shape + (2,)),
                jnp.zeros(shape + (1,)))
    if name == "lafc":
        return jnp.zeros((1, 3, 32, 48, 2)), jnp.zeros((1, 3, 32, 48, 1))
    return jnp.zeros((1, 32, 48, 2)), jnp.zeros((1, 32, 48, 1))


def test_models_keys_equal_jax():
    assert sorted(treg.MODELS) == sorted(jreg.MODELS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_model_matches_jax_parameters(name):
    config, cls = CASES[name]
    port = treg.build_model(name, dict(config))
    assert type(port) is cls and isinstance(port, torch.nn.Module)
    model = jreg.build_model(name, dict(config))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *_jax_inputs(name))
    want = sum(int(np.prod(x.shape)) for x in
               jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in port.parameters()) == want


def test_build_model_lafc_single_forward_equals_jax():
    model = jreg.build_model("lafc_single", dict(LAFC))
    variables = jax.jit(model.init)(jax.random.PRNGKey(3),
                                    *_jax_inputs("lafc_single"))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = treg.build_model("lafc_single", dict(LAFC)).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.mapping_for("lafc_single", LAFC)))
    rng = np.random.RandomState(0)
    flow = (rng.randn(2, 32, 48, 2) * 3).astype(np.float32)
    mask = (rng.rand(2, 32, 48, 1) > 0.7).astype(np.float32)
    want_f, want_e = model.apply(variables, jnp.asarray(flow),
                                 jnp.asarray(mask))
    with torch.no_grad():
        got_f, got_e = port(torch.from_numpy(flow), torch.from_numpy(mask))
    for got, want in ((got_f, want_f), (got_e, want_e)):
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4 * scale)


def test_unknown_model_raises_the_jax_key_error():
    with pytest.raises(KeyError) as jerr:
        jreg.build_model("unet", {})
    with pytest.raises(KeyError) as terr:
        treg.build_model("unet", {})
    assert str(terr.value) == str(jerr.value)
    assert "unknown model 'unet'" in str(terr.value)


class _Clock:
    """A clock that moves 0.75 s a reading."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.75
        return self.t


class _TTY(io.StringIO):
    def isatty(self):
        return True


def _run(module, tty: bool, kind: str) -> str:
    stream = _TTY() if tty else io.StringIO()
    if kind == "bar":
        bar = module.ProgressBar(7, bar_width=30, stream=stream)
        for i in range(7):
            bar.update(f"item {i}")
    elif kind == "open":
        bar = module.ProgressBar(0, stream=stream)
        for _ in range(4):
            bar.update()
    else:
        bar = module.Progbar(5, width=20, stream=stream)
        bar.add(2, values=[("loss", 0.12345678), ("psnr", 31.5)])
        bar.add(3)
    return stream.getvalue()


@pytest.mark.parametrize("kind", ["bar", "open", "progbar"])
@pytest.mark.parametrize("tty", [False, True], ids=["pipe", "tty"])
def test_progress_output_equals_jax(monkeypatch, tty, kind):
    monkeypatch.setattr(shutil, "get_terminal_size",
                        lambda fallback=(80, 24): shutil.os.terminal_size(
                            (120, 40)))
    outputs = []
    for module in (jprog, tprog):
        monkeypatch.setattr(time, "time", _Clock())
        outputs.append(_run(module, tty, kind))
    assert outputs[1] == outputs[0]
    if kind != "open" or tty:
        assert outputs[1]
