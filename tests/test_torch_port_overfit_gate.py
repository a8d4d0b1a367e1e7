"""The port's overfit quality gate (``fgt_tpu_torch/tools/overfit_gate.py``)
against the JAX package's ``tools/overfit_gate.py``, on the CPU:

* the clip makers are bit-equal to ``bench.make_synthetic_data`` and the
  JAX tool's ``make_static_data`` (cv2's 9x9 box filter reproduced in
  numpy), pixel for pixel of the PNGs both write;
* the LAFC and FGT batch builders are bit-equal to the batches the JAX
  tool feeds its steps, captured by replacing its step factories (and
  its models, whose weights the batches do not depend on) with
  recorders;
* both protocols run end to end at a small size (6 frames at 128x224,
  tiny model widths, 2 steps, RAFT small with 2 iterations): finite
  PSNRs, the record's keys, the checkpoint directories the CLI read;
* ``main`` merges its record into ``--out`` (never the JAX package's
  OVERFIT_GATE.json) and exits 1 when a protocol did not improve.
"""

import importlib.util
import json
import os

import imageio.v2 as imageio
import numpy as np
import pytest

from fgt_tpu.models import discriminator as jdisc
from fgt_tpu.models import registry as jregistry
from fgt_tpu.train import fgt_step as jfs
from fgt_tpu.train import lafc_step as jls
from fgt_tpu_torch.tools import overfit_gate as gate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (128, 224)
TINY_LAFC = {"model": "lafc", "num_flows": 3, "cnum": 8, "in_channel": 3,
             "PASSMASK": 1, "use_residual": 1, "resBlocks": 1,
             "use_bias": 1, "conv_type": "vanilla"}
TINY_FGT = {"model": "model", "in_channel": 4, "cnum": 8, "flow_cnum": 8,
            "frame_hidden": 32, "flow_hidden": 16, "numBlocks": 2,
            "num_head": 4, "mlp_ratio": 2, "tw": 2, "sw": 4, "gd": 2}


@pytest.fixture(scope="module")
def jax_gate():
    spec = importlib.util.spec_from_file_location(
        "jax_overfit_gate", os.path.join(ROOT, "tools", "overfit_gate.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_bench():
    """The root ``bench.py``, whose import sets FGT_COSTS for the JAX
    pipeline; the variable is put back as it was."""
    before = os.environ.get("FGT_COSTS")
    import bench
    if before is None:
        os.environ.pop("FGT_COSTS", None)
    return bench


def _pngs(d):
    return np.stack([imageio.imread(os.path.join(d, f))
                     for f in sorted(os.listdir(d))])


@pytest.mark.parametrize("maker", ["synthetic", "static"])
def test_clip_makers_bit_equal_to_jax(tmp_path, jax_gate, jax_bench, maker):
    n = 6
    if maker == "synthetic":
        want = jax_bench.make_synthetic_data(str(tmp_path / "jax"), n=n)
        got = gate.make_synthetic_data(str(tmp_path / "port"), n)
    else:
        want = jax_gate.make_static_data(str(tmp_path / "jax"), n)
        got = gate.make_static_data(str(tmp_path / "port"), n)
    for g, w in zip(got, want):
        a, b = _pngs(g), _pngs(w)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


class _Dummy:
    """A model or discriminator whose init makes no weights."""

    apply = None

    def __init__(self, *a, **kw):
        pass

    def init(self, *a, **kw):
        return {"params": {}, "spectral": {}}


def _recorder(seen, batch_at, result):
    """A step factory whose steps record their batch (positional argument
    ``batch_at``) and return the arguments before it and ``result``."""
    def factory(*a, **kw):
        def step(*args):
            seen.append({k: np.asarray(v) for k, v in args[batch_at].items()})
            return (*args[:batch_at], result)
        return step
    return factory


def test_lafc_batches_bit_equal_to_jax(monkeypatch, jax_gate):
    """Steps 0..9 (the JAX tool's batches repeat every 8 steps)."""
    seen = []
    monkeypatch.setattr(jregistry, "build_model", lambda *a, **k: _Dummy())
    monkeypatch.setattr(jls, "make_lafc_train_step",
                        _recorder(seen, 2, {"loss": np.float32(0)}))
    jax_gate.train_lafc(10, gate.H, gate.W)
    assert len(seen) == 10
    for i, want in enumerate(seen):
        got = gate.lafc_batch(i, gate.H, gate.W)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (i, k)


@pytest.mark.parametrize("pan", [2.0, 0.0])
def test_fgt_batches_bit_equal_to_jax(tmp_path, monkeypatch, jax_gate,
                                      pan):
    seen = []
    frames_dir, _ = gate.make_synthetic_data(str(tmp_path), 8)
    monkeypatch.setattr(jregistry, "build_model", lambda *a, **k: _Dummy())
    monkeypatch.setattr(jdisc, "TemporalPatchGAN", _Dummy)
    monkeypatch.setattr(jfs, "make_fgt_train_step", _recorder(
        seen, 1, {"l1_masked": np.float32(0), "l1_valid": np.float32(0)}))
    jax_gate.train_fgt(9, frames_dir, gate.H, gate.W, pan=pan)
    clip = gate.load_clip(frames_dir, gate.H, gate.W)
    assert len(seen) == 9
    for i, want in enumerate(seen):
        got = gate.fgt_batch(i, clip, gate.H, gate.W, pan=pan)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (i, k)


EXTRA = ("--small", "--raft_iters", "2")


def test_full_recipe_end_to_end_small(tmp_path):
    h, w = SMALL
    rec = gate.run_full(str(tmp_path), 6, 2, 2, "cpu", h, w, TINY_LAFC,
                        TINY_FGT, EXTRA)
    assert np.isfinite(rec["psnr_before_db"]) and \
        np.isfinite(rec["psnr_after_db"])
    assert rec["improved"] == (rec["psnr_after_db"] > rec["psnr_before_db"])
    assert len(rec["lafc_loss_curve"]) == len(rec["fgt_l1_curve"]) == 1
    assert rec["device"] == "cpu"
    for d in ("ck_lafc1", "ck_fgt1"):
        with open(tmp_path / d / "config.json") as f:
            assert json.load(f)["cnum"] == 8
    assert len(os.listdir(tmp_path / "out1" / "frames")) == 6


def test_fgt_only_end_to_end_small(tmp_path):
    h, w = SMALL
    rec = gate.run_fgt_only(str(tmp_path), 6, 2, "cpu", h, w, TINY_LAFC,
                            TINY_FGT, EXTRA)
    assert np.isfinite(rec["hole_psnr_before_db"]) and \
        np.isfinite(rec["hole_psnr_after_db"])
    assert rec["improved"] == (rec["hole_psnr_after_db"]
                               > rec["hole_psnr_before_db"])
    # LAFC stays random: the same directory both times
    assert not (tmp_path / "ck_lafc1").exists()


@pytest.mark.parametrize("improved", [True, False])
def test_main_writes_its_record_and_exits_by_the_verdict(
        tmp_path, monkeypatch, improved):
    out = tmp_path / "gate.json"
    monkeypatch.setattr(gate, "run_full",
                        lambda *a, **k: {"psnr_after_db": 1.0,
                                         "improved": improved})
    monkeypatch.setattr(gate, "run_fgt_only",
                        lambda *a, **k: {"hole_psnr_after_db": 2.0,
                                         "improved": True})
    assert gate.main(["--out", str(out), "--device", "cpu"]) == \
        (0 if improved else 1)
    assert gate.main(["--out", str(out), "--device", "cpu",
                      "--fgt_only"]) == 0
    with open(out) as f:
        rec = json.load(f)
    assert rec["psnr_after_db"] == 1.0 and rec["improved"] == improved
    assert rec["fgt_only"] == {"hole_psnr_after_db": 2.0, "improved": True}
    assert gate.build_parser().parse_args([]).out == \
        "overfit_gate_torch.json"
