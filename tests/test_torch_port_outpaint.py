"""The outpainting probe (``fgt_tpu_torch/tools/outpaint_probe.py``), the
CLI's ``timings.jsonl`` and K2 at ragged lengths, on the CPU, against
the JAX package:

* ``make_pan`` writes the JAX tool's PNG pixels (``tools/outpaint_probe.py``
  imported by path; cv2's ``filter2D`` reproduced by
  ``overfit_gate.box_filter9``);
* the JAX tool's CPU smoke arguments run through the port's probe with
  ``--device cpu`` and print the JAX tool's keys;
* a 2x extrapolation (6 frames of 64x64 onto 128x128) through the port's
  CLI on the fused s1 path (K1's plain version) against the JAX CLI on
  its fused path (the Pallas kernel in interpret mode), same weights;
* K2's plain version at lengths that are not multiples of the CUDA
  kernel's 64-row block against the JAX ``flash_attend`` as the JAX
  tests run it (interpret mode, the JAX blocks of 512 ragged too);
* two CLI runs into one ``outroot`` append two lines to ``timings.jsonl``
  with the JAX CLI's keys (the parent overwrote ``timings.json``).
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_modes import _close_inside, port_models, run_port_cli
from test_torch_port_pipeline import TINY_FGT, TINY_LAFC, _video, \
    run_jax_pipeline
from fgt_tpu_torch.ops import flash_attention as tflash
from fgt_tpu_torch.pipeline import image_io
from fgt_tpu_torch.pipeline import video_inpainting as tvi
from fgt_tpu_torch.tools import outpaint_probe

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = {"metric", "value", "unit", "frames", "canvas", "total_s",
            "stages_s", "peak_host_rss_gb"}
TIMINGS_KEYS = {"stages", "total", "minor_faults", "n_frames", "mode",
                "backoffs"}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_outpaint_probe", os.path.join(REPO, "tools", "outpaint_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,h,w", [(5, 40, 56), (3, 64, 64)])
def test_make_pan_writes_the_jax_tools_pixels(tmp_path, n, h, w):
    import imageio.v2 as imageio

    want_dir = _jax_tool().make_pan(str(tmp_path / "jax"), n, h, w)
    got_dir = outpaint_probe.make_pan(str(tmp_path / "port"), n, h, w)
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) and len(names) == n
    for name in names:
        want = imageio.imread(os.path.join(want_dir, name))
        got = image_io.read_png(os.path.join(got_dir, name))
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_the_jax_tools_cpu_smoke_through_the_port(capsys):
    """``tools/outpaint_probe.py``'s own CPU smoke arguments, plus
    ``--device cpu``: the last line is one JSON object with the JAX
    tool's keys; the line before it holds the back-offs and launches."""
    res = outpaint_probe.main(["--frames", "6", "--imgH", "64", "--imgW",
                               "64", "--h_scale", "1.25", "--w_scale",
                               "1.25", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == JAX_KEYS and last == res
    assert last["metric"] == "outpaint_s_per_frame"
    assert last["unit"] == "s/frame" and last["frames"] == 6
    assert last["canvas"] == [80, 80] and last["value"] > 0
    assert {"s1_raft", "s1b_extrapolation", "s6_fgt", "s7_write"} <= \
        set(last["stages_s"])
    extra = json.loads(lines[-2])
    assert extra["backoffs"] == [] and extra["peak_device_gib"] is None
    assert extra["launches"] == {"lookup_corr_fused": 0, "flash_mhsa": 0,
                                 "poisson_pcg": 0}
    assert json.loads(lines[-3]) == {"device": "cpu"}


def test_probe_flags_are_the_jax_tools():
    import argparse

    jax_parser = argparse.ArgumentParser()
    src = open(os.path.join(REPO, "tools", "outpaint_probe.py")).read()
    for line in src.splitlines():
        line = line.strip()
        if line.startswith("ap.add_argument("):
            eval(line.replace("ap.", "jax_parser.", 1))
    want = vars(jax_parser.parse_known_args([])[0])
    got = vars(outpaint_probe.build_parser().parse_known_args([])[0])
    assert got == want == {"frames": 208, "imgH": 240, "imgW": 432,
                           "h_scale": 2.0, "w_scale": 2.0, "keep": False}


def test_2x_extrapolation_on_the_fused_path_matches_jax(tmp_path):
    """64x64 onto a 2x canvas of 128x128: s1 on the fused path on both
    sides (the port's K1 plain version; the JAX CLI's Pallas kernel under
    ``--fused_corr on``, in interpret mode on the CPU). The centre is the
    input in both; the border, three quarters of the canvas, agrees at
    ``_close_inside``'s tolerance."""
    frames, masks = _video(6, 64, 64, seed=11)
    extra = ("--mode", "video_extrapolation", "--H_scale", "2.0",
             "--W_scale", "2.0", "--fused_corr", "on")
    want, jm = run_jax_pipeline(tmp_path, frames, masks, extra=extra)
    got = run_port_cli(tmp_path, port_models(jm, corr="fused"), (64, 64),
                       extra)
    assert got.shape == want.shape == (6, 128, 128, 3)
    border = np.ones((6, 128, 128), bool)
    border[:, 32:96, 32:96] = False
    np.testing.assert_array_equal(got[:, 32:96, 32:96], frames)
    np.testing.assert_array_equal(want[:, 32:96, 32:96], frames)
    _close_inside(got, want, border)


@pytest.mark.parametrize("l", [577, 2340])
def test_k2_plain_at_ragged_lengths_matches_jax_flash_attend(l):
    """f32 [2, 2, L, 128] at L = 577 (9 CUDA blocks of 64 and one row; the
    JAX kernel's second key block of 512 ragged) and L = 2340 (the main
    path's, 36 rows in the last CUDA block): the port's ``flash_attend``
    (K2's plain version on the CPU) against the JAX ``flash_attend``
    (the Pallas kernel in interpret mode off the TPU) within 2e-5, the
    f32 tolerance K2 is held to on the card; the lse within 1e-4 of a
    float64 logsumexp."""
    from fgt_tpu.ops.flash_attention import flash_attend as jax_flash_attend

    rng = np.random.RandomState(l)
    q, k, v = (rng.randn(2, 2, l, 128).astype(np.float32) for _ in range(3))
    scale = 128 ** -0.5
    want = np.asarray(jax_flash_attend(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale))
    got = tflash.flash_attend(*(torch.from_numpy(a) for a in (q, k, v)),
                              scale).numpy()
    assert got.shape == want.shape == (2, 2, l, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    _, lse = tflash.flash_mhsa(*(torch.from_numpy(a.reshape(4, l, 128))
                                 for a in (q, k, v)), scale)
    s = np.einsum("nqc,nkc->nqk", q.reshape(4, l, 128).astype(np.float64),
                  k.reshape(4, l, 128)) * scale
    top = s.max(-1)
    lse_ref = np.log(np.exp(s - top[..., None]).sum(-1)) + top
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=0, atol=1e-4)


def test_two_cli_runs_append_two_timings_lines(tmp_path):
    """C.2: each run appends one JSON line to ``outroot/timings.jsonl`` as
    the JAX CLI does (``stages``, ``total``, ``minor_faults``, ``n_frames``,
    ``mode``, ``backoffs``); no ``timings.json`` is written."""
    frames, masks = _video(4, 32, 32, seed=12)
    np.save(tmp_path / "frames.npy", frames)
    np.save(tmp_path / "masks.npy", masks)
    models = tvi.Models("cpu", bf16=False, raft_iters=2,
                        lafc_config=TINY_LAFC, fgt_config=TINY_FGT)
    outroot = tmp_path / "out"
    for mode in ("object_removal", "video_extrapolation"):
        args = tvi.build_parser().parse_args([
            "--mode", mode, "--path", str(tmp_path / "frames.npy"),
            "--path_mask", str(tmp_path / "masks.npy"), "--outroot",
            str(outroot), "--imgH", "32", "--imgW", "32", "--raft_iters",
            "2", "--neighbor_stride", "3", "--step", "4", "--f32",
            "--device", "cpu"])
        tvi.video_inpainting(args, models=models)
    assert not (outroot / "timings.json").exists()
    lines = (outroot / "timings.jsonl").read_text().splitlines()
    assert len(lines) == 2
    recs = [json.loads(line) for line in lines]
    for rec, mode in zip(recs, ("object_removal", "video_extrapolation")):
        assert set(rec) == TIMINGS_KEYS
        assert rec["mode"] == mode and rec["n_frames"] == 4
        assert rec["backoffs"] == []
        assert set(rec["minor_faults"]) == set(rec["stages"])
        assert {"s0_load_frames", "s1_raft", "s6_fgt", "s7_write"} <= \
            set(rec["stages"])
        assert rec["total"] == pytest.approx(sum(rec["stages"].values()))
    assert "s1b_extrapolation" in recs[1]["stages"]


def test_backoffs_reach_timings_jsonl(tmp_path, monkeypatch):
    """An OOM in s6 is halved, retried and recorded as the JAX CLI records
    it: ``[stage, chunk, smaller]`` in the run's ``backoffs``."""
    real = tvi.fgt_synthesis
    calls = []

    def oom_once(*a, **kw):
        if not calls:
            calls.append(1)
            tvi.chunk_backoff(_raise_oom, 2, "s6_fgt", a[-1])  # backoffs
        return real(*a, **kw)

    monkeypatch.setattr(tvi, "fgt_synthesis", oom_once)
    frames, masks = _video(4, 32, 32, seed=13)
    np.save(tmp_path / "frames.npy", frames)
    np.save(tmp_path / "masks.npy", masks)
    models = tvi.Models("cpu", bf16=False, raft_iters=2,
                        lafc_config=TINY_LAFC, fgt_config=TINY_FGT)
    args = tvi.build_parser().parse_args([
        "--path", str(tmp_path / "frames.npy"), "--path_mask",
        str(tmp_path / "masks.npy"), "--outroot", str(tmp_path / "out"),
        "--imgH", "32", "--imgW", "32", "--raft_iters", "2", "--f32",
        "--device", "cpu"])
    tvi.video_inpainting(args, models=models)
    rec = json.loads((tmp_path / "out" / "timings.jsonl").read_text()
                     .splitlines()[-1])
    assert rec["backoffs"] == [["s6_fgt", 2, 1]]


def _raise_oom(chunk):
    if chunk > 1:
        raise torch.cuda.OutOfMemoryError("test")
    return chunk
