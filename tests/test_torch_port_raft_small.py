"""RAFT ``--small`` and ``--alternate_corr`` in the port against the JAX
package, on the CPU, and the inference CLI's remaining flags:

* RAFT small (hidden 96, context 64, radius 3) in f32: ``encode`` and
  ``refine`` on K1's plain path and on the all-pairs pyramid (K3's plain
  version), and ``forward``, against ``RAFT(RAFTConfig(small=True))``;
  weights through the port's ``raft_small_mapping``;
* ``corr="alternate"`` (K1's contract in f32) against
  ``RAFTConfig(alternate_corr=True)``, small and big;
* bf16 within twice the JAX package's own bf16 deviation;
* the whole slice with ``--small`` against the JAX CLI's;
* ``--small``, ``--alternate_corr``, ``--mixed_precision``, the
  ``--vis_*`` flags, ``--profile`` and ``--opt`` parse as in the JAX
  CLI, and ``--opt`` overrides as its ``apply_yaml_over_args``;
* the ``--vis_prop`` / ``--vis_*flows`` writers' files decode to the
  arrays the JAX CLI's writers produce from the same inputs.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgt_tpu.models.raft import RAFT, RAFTConfig
from fgt_tpu.pipeline import video_inpainting as jvi
from fgt_tpu_torch.convert import weights
from fgt_tpu_torch.models import raft as traft
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from test_torch_port_bf16 import assert_within_jax_bf16_spread, bf16_tree
from test_torch_port_pipeline import (TINY_FGT, TINY_LAFC, _video,
                                      run_jax_pipeline)

torch.set_num_threads(1)


def _init(cfg, video):
    model = RAFT(cfg)
    variables = jax.jit(lambda r, a, b: model.init(r, a, b, iters=1))(
        jax.random.PRNGKey(0), jnp.asarray(video[:1]), jnp.asarray(video[1:2]))
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def small_pair():
    """JAX RAFT small (2 iterations) and the port's, same weights, on 3
    random 64x64 frames."""
    video = np.random.RandomState(3).randint(0, 255, (3, 64, 64, 3)).astype(
        np.float32)
    model, variables = _init(RAFTConfig(iters=2, small=True), video)
    port = traft.RAFT(small=True).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.raft_small_mapping()))
    return model, variables, port, video


def _t(a):
    return torch.from_numpy(np.array(a))


def test_raft_small_shapes_and_encode_match_jax(small_pair):
    """fnet 128 channels (instance norm), net 96 and inp 64 (cnet without
    norm); f32 features within 1e-4 (conv reassociation over the
    bottleneck encoder)."""
    model, variables, port, video = small_pair
    assert (port.hidden_dim, port.context_dim, port.corr_radius) == (96, 64, 3)
    want = model.apply(variables, jnp.asarray(video), method="encode")
    with torch.no_grad():
        got = port.encode(torch.from_numpy(video))
    assert [g.shape[-1] for g in got] == [128, 96, 64]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("corr", ["fused", "pyramid"])
def test_raft_small_refine_matches_jax(small_pair, corr):
    """2 GRU iterations at radius 3, bilinear x8 upsampling; the port on
    K1's plain path or on the all-pairs pyramid (K3's plain version)
    against the JAX pyramid lookup: 1e-3 px on the 1/8 flow, 5e-3 px
    upsampled (f32 reassociation of the correlation)."""
    model, variables, port, video = small_pair
    fmap, net, inp = model.apply(variables, jnp.asarray(video),
                                 method="encode")
    lo, up = model.apply(variables, fmap[:2], fmap[1:], net[:2], inp[:2],
                         iters=2, method="refine")
    with torch.no_grad():
        lo_t, up_t = port.refine(_t(fmap[:2]), _t(fmap[1:]), _t(net[:2]),
                                 _t(inp[:2]), 2, corr=corr)
    assert up_t.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo), atol=1e-3)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up), atol=5e-3)


def test_raft_small_forward_matches_jax(small_pair):
    """``forward`` = the JAX ``RAFT.__call__`` (both frames through fnet,
    cnet on the first, refine on the pyramid)."""
    model, variables, port, video = small_pair
    lo, up = model.apply(variables, jnp.asarray(video[:2]),
                         jnp.asarray(video[1:]), iters=2)
    with torch.no_grad():
        lo_t, up_t = port(torch.from_numpy(video[:2]),
                          torch.from_numpy(video[1:]), 2)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo), atol=1e-3)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up), atol=5e-3)


def test_upflow8_is_align_corners_bilinear():
    """upflow8 against the JAX function: 8 x bilinear with
    align_corners=True (corner taps exact, f32 weights)."""
    from fgt_tpu.models.raft import upflow8

    flow = np.random.RandomState(0).randn(2, 5, 7, 2).astype(np.float32)
    want = np.asarray(upflow8(jnp.asarray(flow)))
    got = traft.upflow8(torch.from_numpy(flow).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    corners = np.ix_(range(2), [0, -1], [0, -1], range(2))
    np.testing.assert_array_equal(got[corners], 8 * flow[corners])


@pytest.mark.parametrize("small", [True, False])
def test_alternate_corr_matches_jax(small):
    """``refine(corr="alternate")`` against ``alternate_corr=True``
    (chunked on-the-fly correlation), 2 iterations, same tolerances."""
    video = np.random.RandomState(4).randint(0, 255, (2, 64, 64, 3)).astype(
        np.float32)
    model, variables = _init(RAFTConfig(iters=2, small=small,
                                        alternate_corr=True), video)
    port = traft.RAFT(small=small).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.raft_small_mapping() if small
        else weights.raft_mapping()))
    lo, up = model.apply(variables, jnp.asarray(video[:1]),
                         jnp.asarray(video[1:]), iters=2)
    with torch.no_grad():
        fmap, net, inp = port.encode(torch.from_numpy(video))
        lo_t, up_t = port.refine(fmap[:1], fmap[1:], net[:1], inp[:1], 2,
                                 corr="alternate")
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo), atol=1e-3)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up), atol=5e-3)


def _jax_small_flow(variables, video, corr, dtype):
    """The JAX s1 on one pair with RAFT small: parameters and frames in
    ``dtype``, encode, 4 GRU iterations; ``corr`` "pyramid" (bf16 storage
    under bf16), "fused" (the Pallas kernel in interpret mode) or
    "alternate"."""
    bf16 = dtype == jnp.bfloat16
    model = RAFT(RAFTConfig(iters=4, small=True, fused_corr=corr == "fused",
                            alternate_corr=corr == "alternate",
                            corr_dtype="bfloat16" if bf16 else "float32"))
    v = bf16_tree(variables) if bf16 else variables

    @jax.jit
    def run(v, video):
        fmap, net, inp = model.apply(v, video, method="encode")
        return model.apply(v, fmap[:1], fmap[1:], net[:1], inp[:1], iters=4,
                           method="refine")[1]

    return np.asarray(run(v, jnp.asarray(video, dtype)).astype(jnp.float32))


@pytest.mark.parametrize("corr", ["pyramid", "fused", "alternate"])
def test_raft_small_bf16_within_jax_spread(corr):
    """RAFT small in bf16 on a 64x64 pair of the pipeline tests' panning
    clip: |port_bf16 - jax_bf16| <= 2 |jax_bf16 - jax_f32| (relative to
    the largest f32 flow) on each correlation path; the alternate path
    keeps its features and taps in f32 on both sides."""
    video = _video(2, 64, 64, seed=0)[0].astype(np.float32)
    _, variables = _init(RAFTConfig(iters=4, small=True), video)
    port = traft.RAFT(small=True).eval()
    weights.load_state(port, weights.jax_to_torch_state(
        variables, weights.raft_small_mapping()))
    want32 = _jax_small_flow(variables, video, corr, jnp.float32)
    want16 = _jax_small_flow(variables, video, corr, jnp.bfloat16)
    model = copy.deepcopy(port).to(torch.bfloat16)
    with torch.no_grad():
        fmap, net, inp = model.encode(torch.from_numpy(video))
        got = model.refine(fmap[:1], fmap[1:], net[:1], inp[:1], 4,
                           corr=corr)[1].float().numpy()
    assert got.shape == want16.shape == (1, 64, 64, 2)
    assert_within_jax_bf16_spread(got, want16, want32, corr)


def test_whole_slice_small_matches_jax_pipeline(tmp_path):
    """``--small`` end to end: the JAX CLI in f32 against the port's
    ``inpaint`` with the same RAFT-small, LAFC and FGT weights (K1's
    plain path in s1), 6 frames at 64x64, with the bound of
    test_torch_port_pipeline's whole-slice test."""
    frames, masks = _video(6, 64, 64, seed=3)
    want, jm = run_jax_pipeline(tmp_path, frames, masks, extra=("--small",))
    assert jm.raft_cfg.small
    np_vars = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    models = tvi.Models(
        "cpu", bf16=False, raft_iters=2, lafc_config=TINY_LAFC,
        fgt_config=TINY_FGT, small=True,
        raft_state=weights.jax_to_torch_state(np_vars(jm.raft_vars),
                                              weights.raft_small_mapping()),
        lafc_state=weights.jax_to_torch_state(np_vars(jm.lafc_vars),
                                              weights.lafc_mapping(1)),
        fgt_state=weights.jax_to_torch_state(np_vars(jm.fgt_vars),
                                             weights.fgt_mapping(2)))
    got = tvi.inpaint(frames, masks, models, flow_mask_dilates=2,
                      neighbor_stride=3, step=4)
    hole = masks > 0
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    d = np.abs(got.astype(int) - want.astype(int))[hole]
    assert d.mean() <= 0.25 and (d > 1).mean() <= 0.01, (d.mean(), d.max())


NEW_FLAGS = ("opt", "small", "mixed_precision", "alternate_corr",
             "vis_flows", "vis_completed_flows", "vis_prop", "vis_frame",
             "profile")


@pytest.mark.parametrize("argv", [
    [], ["--small"], ["--alternate_corr", "--fused_corr", "off"],
    ["--mixed_precision"],
    ["--vis_flows", "--vis_completed_flows", "--vis_prop", "--vis_frame"],
    ["--profile", "trace_dir", "--opt", "run.yaml", "--small"]])
def test_new_flags_parse_as_the_jax_cli(argv):
    """The flags read the same values from the same argv in both
    parsers; the port's models take the small variant and the f32 K1
    path from them (--alternate_corr wins over --fused_corr)."""
    jargs = jvi.build_parser().parse_args(argv)
    targs = tvi.build_parser().parse_args(argv)
    for flag in NEW_FLAGS:
        assert getattr(targs, flag) == getattr(jargs, flag), flag
    targs.device, targs.raft_iters = "cpu", 1
    targs.lafc_ckpts = targs.fgt_ckpts = targs.raft_model = "/nonexistent"
    models = tvi.build_models(targs)
    assert models.raft.small == ("--small" in argv)
    assert models.corr == ("alternate" if "--alternate_corr" in argv
                           else "fused")


def test_opt_overrides_as_the_jax_cli(tmp_path):
    """``--opt``: the YAML's keys win over the parsed flags, only keys
    the namespace has (the JAX CLI's ``apply_yaml_over_args`` with
    PyYAML; the port's with ``read_flat_yaml``)."""
    from fgt_tpu.utils.config import apply_yaml_over_args as japply
    from fgt_tpu_torch.utils.config import apply_yaml_over_args as tapply

    path = tmp_path / "run.yaml"
    path.write_text("# inference overrides\nraft_iters: 3\nsmall: true\n"
                    "imgH: 120\nalpha: 0.25\nfused_corr: 'off'\n"
                    "mode: video_extrapolation\nnot_a_flag: 7\n"
                    "datasets:\n  train: x\n")
    argv = ["--opt", str(path), "--imgH", "64", "--raft_iters", "9"]
    parsed = vars(tvi.build_parser().parse_args(argv))
    jargs = japply(jvi.build_parser().parse_args(argv), str(path))
    targs = tapply(tvi.build_parser().parse_args(argv), str(path))
    yaml_keys = {"raft_iters", "small", "imgH", "alpha", "fused_corr",
                 "mode"}
    for k in yaml_keys:
        assert getattr(targs, k) == getattr(jargs, k), k
    for k in set(parsed) - yaml_keys:
        assert getattr(targs, k) == parsed[k], k
    assert (targs.raft_iters, targs.small, targs.imgH, targs.fused_corr) == \
        (3, True, 120, "off")
    assert not hasattr(targs, "not_a_flag") and not hasattr(targs,
                                                            "datasets")
    assert tapply(targs, None) is targs


def _decode_tree(root):
    """{relative path: decoded array} of every PNG / .npy / .flo under
    ``root`` (PNGs through imageio, as a user would read them)."""
    import imageio.v2 as imageio

    from fgt_tpu.core import flow_io as jflow_io

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".png"):
                out[rel] = imageio.imread(p)
            elif f.endswith(".npy"):
                out[rel] = np.load(p)
            elif f.endswith(".flo"):
                out[rel] = jflow_io.read_flow(p)
    return out


def test_vis_writers_decode_as_the_jax_cli(tmp_path):
    """``save_prop`` / ``save_flows`` against the JAX CLI's ``_save_prop``
    (cv2.imwrite of RGB floats: channels reversed in the file, rounded to
    nearest and saturated) and ``_save_flows`` (.flo + imageio PNGs of
    the flow colours, truncated): same files, decoding to equal arrays."""
    rng = np.random.RandomState(8)
    n, h, w = 3, 20, 28
    blends = [rng.uniform(-0.05, 1.05, (h, w, 3)) for _ in range(n - 1)]
    blends[0][0, :4, 0] = (np.arange(4) + 0.5) / 255.0   # near-ties
    blends.append(rng.rand(h, w, 3).astype(np.float32))  # a frame w/o hole
    left = rng.rand(n, h, w) > 0.7
    flows = rng.randn(2, n - 1, h, w, 2).astype(np.float32) * 4
    for tag, prop, save in (("jax", jvi._save_prop, jvi._save_flows),
                            ("port", tvi.save_prop, tvi.save_flows)):
        prop(str(tmp_path / tag), blends, left)
        save(str(tmp_path / tag), flows[0], flows[1])
        save(str(tmp_path / tag), flows[1], flows[0], subdir="flow")
    want, got = _decode_tree(tmp_path / "jax"), _decode_tree(tmp_path / "port")
    assert set(got) == set(want) and len(want) == 4 * n + 8 * (n - 1)
    for rel, arr in want.items():
        assert got[rel].dtype == arr.dtype and got[rel].shape == arr.shape, rel
        np.testing.assert_array_equal(got[rel], arr, err_msg=rel)
    assert want["prop_frames/00000.png"].ndim == 3


def test_cli_debug_flags_write_the_jax_directories(tmp_path):
    """The port's CLI on the CPU at 32x32 with every debug flag: the
    --vis_* directories hold N-1 flows per direction and N propagation
    frames, --opt's raft_iters wins over the flag (K1's plain version
    runs 3 times in s1), --profile writes a Chrome trace."""
    import json

    from fgt_tpu_torch.ops import corr_fused
    from fgt_tpu_torch.pipeline import image_io

    frames, masks = _video(4, 32, 32, seed=4)
    for sub in ("frames", "masks", "lafc", "fgt"):
        (tmp_path / sub).mkdir()
    for i, (fr, m) in enumerate(zip(frames, masks)):
        image_io.write_png(str(tmp_path / "frames" / f"{i:05d}.png"), fr)
        image_io.write_png(str(tmp_path / "masks" / f"{i:05d}.png"), m * 255)
    for sub, cfg in (("lafc", TINY_LAFC), ("fgt", TINY_FGT)):
        with open(tmp_path / sub / "config.json", "w") as f:
            json.dump(cfg, f)
    (tmp_path / "opt.yaml").write_text("raft_iters: 3\n")
    calls = []
    plain = corr_fused.lookup_corr_plain

    def counted(*a):
        calls.append(1)
        return plain(*a)

    corr_fused.lookup_corr_plain = counted
    try:
        out = tvi.main([
            "--path", str(tmp_path / "frames"), "--path_mask",
            str(tmp_path / "masks"), "--outroot", str(tmp_path / "out"),
            "--lafc_ckpts", str(tmp_path / "lafc"), "--fgt_ckpts",
            str(tmp_path / "fgt"), "--raft_model", "/nonexistent",
            "--imgH", "32", "--imgW", "32", "--raft_iters", "1",
            "--flow_mask_dilates", "1", "--neighbor_stride", "2", "--step",
            "2", "--f32", "--device", "cpu", "--vis_flows",
            "--vis_completed_flows", "--vis_prop", "--vis_frame",
            "--profile", str(tmp_path / "trace"), "--opt",
            str(tmp_path / "opt.yaml")])
    finally:
        corr_fused.lookup_corr_plain = plain
    assert len(calls) == 3
    root = os.path.dirname(out)
    want = {f"{d}/{name}_{kind}": 3 for d in ("flow", "completed_flow")
            for name in ("forward", "backward") for kind in ("flo", "png")}
    want.update({d: 4 for d in ("prop_frames", "masks_left",
                                "prop_frames_npy", "masks_left_npy",
                                "frames")})
    assert {d: len(os.listdir(os.path.join(root, d))) for d in want} == want
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
