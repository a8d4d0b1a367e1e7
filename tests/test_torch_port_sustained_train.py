"""The port's sustained-training tool (``fgt_tpu_torch/tools/
sustained_train.py``) against the JAX package's ``tools/sustained_train.
py``, on the CPU at tiny sizes:

* the synthetic tree from the same seed: the ``.flo`` files bit-equal,
  the frames before encoding bit-equal (cv2's 9x9 ``filter2D`` as
  ``overfit_gate.box_filter9``), and the JPEG frames as cv2 decodes them
  near the JAX tool's: the port's baseline encoder (float DCT) stands in
  for Pillow's libjpeg at quality 92, 4:2:0. Measured here: at most 6
  levels apart, 0.63 on average (at 240x432: 11 and 0.59), each as far
  from the source frame as the other (2.59 levels on average);
* ``build_opt`` against the dict the JAX tool hands its trainer (caught
  by a stub trainer): equal but for the oracle's path;
* ``summarize`` on a real port ``FGTTrainer`` run at tiny widths, 48
  steps: the LR boundary crossed (``lr_decayed``), two validations, the
  checkpoint trio, the JAX record's keys;
* ``main`` without ``--device`` on a machine without a card raises
  rather than training on the CPU.
"""

import argparse
import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from fgt_tpu_torch.tools import sustained_train as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(cnum=8, flow_cnum=8, frame_hidden=32, flow_hidden=16,
            numBlocks=2, mlp_ratio=2, dist_cnum=8,
            flow_config=dict(st.FLOW_CFG, cnum=8))


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_sustained_train", os.path.join(ROOT, "tools",
                                            "sustained_train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_video_tree_equals_the_jax_tools(tmp_path, monkeypatch, jax_tool):
    import imageio.v2 as imageio

    raw = []
    write = imageio.imwrite

    def keep(path, img, **kw):
        raw.append(np.array(img))
        return write(path, img, **kw)

    monkeypatch.setattr(imageio, "imwrite", keep)
    size = dict(h=24, w=40, flow_h=12, flow_w=20)
    jax_tool._write_video_tree(str(tmp_path / "jax"), 3, 5, seed=7, **size)
    monkeypatch.undo()
    st.write_video_tree(str(tmp_path / "port"), 3, 5, seed=7, **size)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and len(names) == 3 * (5 + 8)
    frames = np.concatenate([f for f, _ in st.video_clips(3, 5, seed=7,
                                                          **size)])
    np.testing.assert_array_equal(frames, np.stack(raw))
    diffs, errors = [], []
    for name in names:
        a, b = (str(tmp_path / side / name) for side in ("jax", "port"))
        if name.endswith(".flo"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
        else:
            jax_px, port_px = (cv2.imread(p)[..., ::-1].astype(int)
                               for p in (a, b))
            diffs.append(np.abs(jax_px - port_px))
            src = raw[len(errors)]
            errors.append([np.abs(x - src).mean() for x in (jax_px, port_px)])
    diffs = np.stack(diffs)
    assert diffs.max() <= 6 and diffs.mean() <= 0.65, (diffs.max(),
                                                       diffs.mean())
    jax_err, port_err = np.mean(errors, axis=0)
    assert port_err <= 1.01 * jax_err, (port_err, jax_err)


def _args(argv=()):
    return st.build_parser().parse_args(list(argv))


def test_build_opt_equals_the_jax_tools(tmp_path, monkeypatch, jax_tool):
    """The JAX tool's ``main`` up to its trainer: the trees and oracle
    it would write are already there (so it writes none), its heap
    pinning is a no-op, and ``FGTTrainer`` is a stub that keeps ``opt``."""
    from fgt_tpu.train import trainer as jax_trainer
    from fgt_tpu.utils import hostmem

    class Caught(Exception):
        pass

    root = str(tmp_path)
    for d in ("frames", os.path.join("val", "frames")):
        os.makedirs(os.path.join(root, d))
    open(os.path.join(root, "lafc_single.msgpack"), "w").close()
    argv = ["--steps", "900", "--videos", "5", "--batch", "3",
            "--val_every_steps", "250", "--workers", "4", "--imgH", "120",
            "--imgW", "216", "--root", root]
    got = {}

    def stub(opt, *a, **kw):
        got.update(opt)
        raise Caught

    monkeypatch.setattr(jax_trainer, "FGTTrainer", stub)
    monkeypatch.setattr(hostmem, "retain_heap", lambda: None)
    monkeypatch.setattr(sys, "argv", ["sustained_train.py"] + argv)
    with pytest.raises(Caught):
        jax_tool.main()
    monkeypatch.undo()
    want = st.build_opt(_args(argv), root, os.path.join(root, "x.pth"))
    assert got.pop("flow_checkPoint").endswith("lafc_single.msgpack")
    assert want.pop("flow_checkPoint").endswith("x.pth")
    assert got == want
    assert want["train"]["val_freq"] == 125 and \
        want["train"]["UPDATE_INTERVAL"] == 450


def test_summarize_a_short_real_run(tmp_path, monkeypatch):
    """48 steps of a tiny FGT (widths overridden in ``opt``) on a 2-video
    tree at 32x32: the LR decays at step 24 (logs at 16, 32, 48, each the
    running mean of the LRs logged), validation every 16 steps (8 epochs
    of 2 steps; none after the last), the trio written at the end. The
    metrics stream's TensorBoard twin is left out (its import takes 12 s
    here; the record reads the JSONL stream)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    torch.manual_seed(0)
    args = _args(["--steps", "48", "--videos", "2", "--frames", "6",
                  "--imgH", "32", "--imgW", "32", "--batch", "1",
                  "--val_every_steps", "16", "--workers", "0",
                  "--device", "cpu", "--root", str(tmp_path)])
    root = str(tmp_path)
    st.write_video_tree(root, 2, 6, 32, 32, 16, 16, seed=0)
    st.write_video_tree(os.path.join(root, "val"), 2, 14, 32, 32, 16, 16,
                        seed=99)
    opt = st.build_opt(args, root, os.path.join(root, "oracle.pth"))
    opt.update(TINY, res_h=32, res_w=32)
    opt["datasets"]["valInfo"].update(num_videos=2, pivot=6,
                                      flow_mask_rect=12)
    st.write_oracle(opt["flow_checkPoint"], opt["flow_config"])
    trainer, clock, init_s, wall, launches = st.run(opt, "cpu")
    rec = st.summarize(trainer, args, wall, init_s, 0.0, clock, launches)
    assert rec["metric"] == "fgt_trainer_sustained_48steps_32x32_b1_bf16"
    assert [r["step"] for r in rec["validations"]] == [16, 32]
    assert all(np.isfinite(v) for r in rec["validations"]
               for k, v in r.items() if k != "step")
    assert rec["lr_first"] == 1e-4 and rec["lr_decayed"]
    assert rec["curves"]["step"] == [16, 32, 48]
    assert rec["losses_finite"] and rec["global_batch"] == 1
    assert [c.split("_")[0] for c in rec["checkpoints"]] == [
        "dist", "gen", "opt"]
    assert rec["device"] == "cpu" and rec["peak_gib"] is None
    assert launches == {k.__name__: 0 for k in st.KERNELS}   # plain on CPU
    assert len(clock.steps) == 48 and len(clock.vals) == 2
    assert 0 <= rec["host_data_share"] < 1
    json.dumps(rec)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is here")
def test_main_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="--device cpu"):
        st.main(["--root", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")
    assert isinstance(st.build_parser(), argparse.ArgumentParser)
