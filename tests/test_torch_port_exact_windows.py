"""The inference CLI's ``--exact_windows`` and ``--host_diffusion`` in the
port against the JAX package, on the CPU, in f32:

* s6 under ``--exact_windows``: ``fgt_synthesis_exact`` against
  ``fgt_synthesis(exact_windows=True)`` with the same tiny FGT on the
  same float Poisson frames (one forward per window, neighbours
  truncated at the ends, the reference's global refs); the window
  lengths at 24 frames (8, 12, 13, 12, 11, so 5 forwards);
* s2 under ``--host_diffusion``: ``native.diffuse_flows`` against the
  JAX package's ``diffusion()`` (its native build of the same source,
  or its scipy fallback) on holes that take the multigrid and the SOR
  route, and the port's ``complete_flows`` feeding LAFC from it;
* the whole slice with each flag against the JAX CLI (6 frames at
  64x64, 2 RAFT iterations, the tiny LAFC and FGT of
  ``test_torch_port_pipeline.py``).

Tolerances. s6: outside the hole the input bytes come back exactly;
inside, at most 1 LSB (f32 reassociation can move a value across an
integer before the trunc-cast). Diffusion: equal to the JAX package's
native solve (same source and flags); against its scipy fallback, an
exact sparse solve, 2e-5 of the flows' largest magnitude (the multigrid
stops at a relative residual of 1e-7). The whole slice: the bound of
``test_whole_slice_matches_jax_pipeline``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from fgt_tpu.core.region_fill import regionfill
from fgt_tpu.models.fgt import Model as JaxFGT
from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu_torch import native
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import fgt as tfgt
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from test_torch_port_pipeline import (TINY_FGT, TINY_LAFC, _video,
                                      run_jax_pipeline)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fgt_pair():
    model = JaxFGT(config=TINY_FGT)
    shape = (1, 2, 64, 64)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(5), jnp.zeros(shape + (3,)),
        jnp.zeros(shape + (2,)), jnp.zeros(shape + (1,))))
    port = tfgt.Model(TINY_FGT).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.fgt_mapping(TINY_FGT["numBlocks"])))
    return model, variables, port


def _jax_models(model, variables):
    """The JAX pipeline's Models with only what ``fgt_synthesis`` reads."""
    m = jvi.Models.__new__(jvi.Models)
    m.fgt_model, m.fgt_vars, m.fgt_config = model, variables, dict(TINY_FGT)
    m.dtype, m.mesh = jnp.float32, None
    m._jit_cache, m._variant_cache = {}, {}
    return m


def _port_models(port):
    models = tvi.Models.__new__(tvi.Models)
    models.fgt, models.dtype = port, torch.float32
    return models


def test_s6_exact_windows_match_jax(fgt_pair):
    """9 frames, neighbour stride 3, step 4: windows of 4, 7 and 6
    neighbours (truncated at both ends) plus 2, 1 and 1 refs. The frames are float
    (Poisson's f64 output, not multiples of 1/255): FGT must read them
    unrounded and the composite keep trunc(frames·255)."""
    model, variables, port = fgt_pair
    rng = np.random.RandomState(7)
    n, h, w = 9, 64, 64
    frames = scipy.ndimage.uniform_filter(rng.rand(n, h, w, 3),
                                          size=(1, 5, 5, 1))
    masks = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        masks[i, 18:38, 12 + 2 * i:36 + 2 * i] = 1
    flows = rng.randn(n - 1, h, w, 2).astype(np.float32)
    want = jvi.fgt_synthesis(_jax_models(model, variables), frames,
                             masks[..., None].astype(np.float32), flows,
                             neighbor_stride=3, step=4, num_ref=-1,
                             exact_windows=True)
    want = np.stack([c.astype(np.uint8) for c in want])
    shapes = []
    hook = port.register_forward_hook(
        lambda mod, args, out: shapes.append(args[0].shape[1]))
    try:
        with torch.no_grad():
            got = tvi.fgt_synthesis_exact(
                _port_models(port), frames, torch.from_numpy(masks),
                torch.from_numpy(flows), neighbor_stride=3, step=4).numpy()
    finally:
        hook.remove()
    windows = [list(range(max(0, f - 3), min(n, f + 4))) for f in (0, 3, 6)]
    assert shapes == [len(nb) + len(jvi.get_ref_index(f, nb, n, 4, -1))
                      for f, nb in zip((0, 3, 6), windows)] == [6, 8, 7]
    out = masks == 0
    np.testing.assert_array_equal(got[out], want[out])
    np.testing.assert_array_equal(got[out], (frames * 255).astype(
        np.uint8)[out])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()


def test_exact_windows_at_24_frames_run_five_forwards():
    """The main path's clip: pivots 0, 5, 10, 15, 20 hold 8, 12, 13, 12
    and 11 frames (the batched path: five windows of 13), so K2 runs 5
    forwards x its temporal blocks."""
    lengths = []

    class Recorder(torch.nn.Module):
        def forward(self, frames, flows, masks):
            lengths.append(frames.shape[1])
            return torch.zeros_like(frames)

    models = _port_models(Recorder())
    n = 24
    tvi.fgt_synthesis_exact(models, np.zeros((n, 8, 8, 3)),
                            torch.zeros(n, 8, 8, dtype=torch.uint8),
                            torch.zeros(n - 1, 8, 8, 2))
    assert lengths == [8, 12, 13, 12, 11]


def _flows_and_holes(t, h, w, seed):
    rng = np.random.RandomState(seed)
    flows = scipy.ndimage.uniform_filter(
        rng.randn(t, h, w, 2).astype(np.float32) * 6, size=(1, 7, 7, 1))
    masks = np.zeros((t, h, w), np.uint8)
    for i in range(t):
        masks[i, h // 4:h // 4 + h // 2 - i, w // 5 + i:w // 5 + w // 2] = 1
    return flows, masks


@pytest.mark.parametrize("shape", [(3, 40, 56), (2, 96, 128)],
                         ids=["sor", "multigrid"])
def test_host_diffusion_matches_jax_diffusion(shape):
    """``native.diffuse_flows`` (the port's build of the source) against
    the JAX ``diffusion()``: bit-equal to its native build; against its
    scipy fallback (regionfill per plane) within 2e-5 of max |flow|."""
    from fgt_tpu import native as jnative

    flows, masks = _flows_and_holes(*shape, seed=sum(shape))
    got = native.diffuse_flows(flows * (1 - masks[..., None]), masks > 0)
    if jnative.available():
        want = jvi.diffusion(flows, masks[..., None].astype(np.float32))
        np.testing.assert_array_equal(got, want)
    exact = np.stack([np.stack([regionfill(f[..., c], m) for c in (0, 1)],
                               -1) for f, m in zip(flows, masks)])
    np.testing.assert_allclose(got, exact, rtol=0,
                               atol=2e-5 * np.abs(flows).max())
    outside = masks == 0
    np.testing.assert_array_equal(got[outside], flows[outside])


def test_complete_flows_feeds_lafc_the_host_diffusion(monkeypatch):
    """``complete_flows(host_diffusion=True)`` hands LAFC the native
    solve's windows, and the device solve stays out of it."""
    flows, masks = _flows_and_holes(4, 40, 56, seed=3)
    seen = []

    class Recorder(torch.nn.Module):
        def forward(self, wf, wm, with_edge=False):
            seen.append(wf.clone())
            return wf[:, 1], None

    monkeypatch.setattr(tvi, "diffuse_flows_device", None)
    models = tvi.Models.__new__(tvi.Models)
    models.lafc, models.lafc_config = Recorder(), dict(TINY_LAFC)
    out = tvi.complete_flows(models, torch.from_numpy(flows),
                             torch.from_numpy(masks), chunk=4,
                             host_diffusion=True)
    diffused = native.diffuse_flows(flows * (1 - masks[..., None]),
                                    masks > 0)
    ids = [tvi.indices_gen(i, 3, 3, 4) for i in range(4)]
    np.testing.assert_array_equal(seen[0].numpy(), diffused[ids])
    np.testing.assert_array_equal(out.numpy(), diffused)


@pytest.mark.parametrize("flag", ["--exact_windows", "--host_diffusion"])
def test_whole_slice_with_flag_matches_jax_cli(tmp_path, flag):
    """6 frames at 64x64 through the JAX CLI with the flag, and through
    the port's ``inpaint`` with the same weights and option: outside the
    hole both return the input bytes; inside, the whole-slice bound."""
    frames, masks = _video(6, 64, 64, seed=3)
    want, jm = run_jax_pipeline(tmp_path, frames, masks, extra=(flag,))
    np_vars = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    models = tvi.Models(
        "cpu", bf16=False, raft_iters=2, lafc_config=TINY_LAFC,
        fgt_config=TINY_FGT,
        raft_state=weights.jax_to_torch_state(np_vars(jm.raft_vars),
                                              weights.raft_mapping()),
        lafc_state=weights.jax_to_torch_state(np_vars(jm.lafc_vars),
                                              weights.lafc_mapping(1)),
        fgt_state=weights.jax_to_torch_state(np_vars(jm.fgt_vars),
                                             weights.fgt_mapping(2)))
    got = tvi.inpaint(frames, masks, models, flow_mask_dilates=2,
                      neighbor_stride=3, step=4,
                      exact_windows=flag == "--exact_windows",
                      host_diffusion=flag == "--host_diffusion")
    hole = masks > 0
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    np.testing.assert_array_equal(want[~hole], frames[~hole])
    d = np.abs(got.astype(int) - want.astype(int))[hole]
    assert d.mean() <= 0.25 and (d > 1).mean() <= 0.01, (d.mean(), d.max())
