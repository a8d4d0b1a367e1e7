"""LAFC and the s2 diffusion in the PyTorch port vs the JAX package, on
the CPU, in f32, with the same weights moved through
``convert.weights.jax_to_torch_state``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from fgt_tpu.models.lafc import Model as JaxLAFC
from fgt_tpu.ops.diffusion_tpu import diffuse_flows_device as jax_diffuse
from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import lafc as tlafc
from fgt_tpu_torch.ops.diffusion import diffuse_flows_device
from fgt_tpu_torch.pipeline import video_inpainting as tvi

torch.set_num_threads(1)

LAFC_CFG = {"model": "lafc", "num_flows": 3, "flow_interval": 3, "cnum": 8,
            "in_channel": 3, "PASSMASK": 1, "use_residual": 1,
            "resBlocks": 1, "use_bias": 1, "conv_type": "vanilla",
            "use_edges": 0}


def _smooth_flows(rng, t, h, w):
    f = rng.randn(t, h, w, 2).astype(np.float32) * 4
    return scipy.ndimage.uniform_filter(f, size=(1, 7, 7, 1)).astype(
        np.float32)


@pytest.fixture(scope="module")
def lafc_pair():
    model = JaxLAFC(config=LAFC_CFG)
    flows = jnp.zeros((1, 3, 32, 48, 2))
    masks = jnp.zeros((1, 3, 32, 48, 1))
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), flows, masks)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = tlafc.Model(LAFC_CFG).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.lafc_mapping(1)))
    return model, variables, port


def test_lafc_model_matches_jax(lafc_pair):
    """Flow and edge heads, f32; tolerance 1e-4 relative to the output
    scale (conv reassociation through ~20 conv layers)."""
    model, variables, port = lafc_pair
    rng = np.random.RandomState(0)
    flows = _smooth_flows(rng, 6, 32, 48).reshape(2, 3, 32, 48, 2)
    masks = (rng.rand(2, 3, 32, 48, 1) > 0.7).astype(np.float32)
    want_f, want_e = model.apply(variables, jnp.asarray(flows),
                                 jnp.asarray(masks))
    with torch.no_grad():
        got_f, got_e = port(torch.from_numpy(flows), torch.from_numpy(masks))
    scale = float(np.abs(np.asarray(want_f)).max())
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-5)


def test_diffusion_matches_jax():
    """Interior, border and corner holes, an empty plane: exact outside
    the hole; inside, both f32 PCG solves stop at rtol 1e-6 of the
    residual, so they agree to 2e-4 like the JAX solve and the f64 host
    solve (tests/test_diffusion_tpu.py)."""
    rng = np.random.RandomState(0)
    t, h, w = 4, 48, 64
    flows = _smooth_flows(rng, t, h, w)
    masks = np.zeros((t, h, w), np.float32)
    masks[0, 10:30, 20:44] = 1
    masks[1, 0:20, 0:16] = 1
    masks[2, 30:48, 30:60] = 1
    got = diffuse_flows_device(torch.from_numpy(flows),
                               torch.from_numpy(masks)).numpy()
    want = np.asarray(jax_diffuse(jnp.asarray(flows), jnp.asarray(masks)))
    outside = masks == 0
    np.testing.assert_array_equal(got[outside], flows[outside])
    assert np.abs(got - want).max() < 2e-4, np.abs(got - want).max()


def test_s2_complete_flows_matches_jax_composition(lafc_pair):
    """The s2 driver: diffusion, reflect-indexed windows (indices_gen),
    LAFC, pivot composite out·m + flow·(1-m). Reference composed here
    from the JAX functions. Outside the mask the raw flow is returned
    bit-exactly; inside, 1e-3 absolute (diffusion 2e-4 through the
    net)."""
    model, variables, port = lafc_pair
    rng = np.random.RandomState(1)
    t, h, w = 5, 32, 48
    flows = _smooth_flows(rng, t, h, w)
    masks = np.zeros((t, h, w), np.uint8)
    for i in range(t):
        masks[i, 8:20, 10 + i:26 + i] = 1
    diffused = np.asarray(jax_diffuse(jnp.asarray(flows), jnp.asarray(masks)))
    ids = np.asarray([jvi.indices_gen(i, 3, 3, t) for i in range(t)])
    out, _ = model.apply(variables, jnp.asarray(diffused[ids]),
                         jnp.asarray(masks[ids][..., None].astype(np.float32)))
    m = masks[..., None].astype(np.float32)
    want = np.asarray(out) * m + flows * (1 - m)

    models = tvi.Models.__new__(tvi.Models)
    models.lafc, models.lafc_config = port, LAFC_CFG
    with torch.no_grad():
        got = tvi.complete_flows(models, torch.from_numpy(flows),
                                 torch.from_numpy(masks), chunk=2).numpy()
    np.testing.assert_array_equal(got[masks == 0], flows[masks == 0])
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_indices_gen_and_ref_index_match_jax():
    for t in (3, 7, 23):
        for p in range(t):
            assert tvi.indices_gen(p, 3, 3, t) == jvi.indices_gen(p, 3, 3, t)
    for n, ns, step in ((24, 5, 10), (6, 3, 4), (13, 5, 10)):
        ids, tn = tvi.fgt_window_ids(n, ns, step, -1)
        jids, jtn = jvi.fgt_window_ids(n, ns, step, -1)
        assert tn == jtn
        np.testing.assert_array_equal(ids, jids)
