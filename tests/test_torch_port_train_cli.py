"""The port's training CLI against the JAX package's, on the CPU:

* ``build_opt`` equal to ``fgt_tpu.train.train.build_opt`` for the three
  committed training configs (the port's one extra key, ``device``, is
  listed);
* a short CPU run of each model (``lafc_single``, ``lafc``, ``model``)
  through ``main([... '--device', 'cpu', '--use_valid'])`` on a
  PNG + ``.flo`` tree (4 videos x 10 frames at 48x64) with copies of the
  committed configs cut to tiny widths at 32x32 (``n_workers`` 0): the
  first batch equals the first batch of ``fgt_tpu.data.create_dataloader``
  under the JAX trainer's seeding, every loss is finite, validation on
  a DAVIS-style tree writes ``val/*`` to ``metrics.jsonl``, and FGT takes
  the LAFC-single run's ``latest/model.pth`` as its oracle;
* the CLI runs on the card unless told otherwise and does not fall back
  to the CPU; ``--tp``/``--sp`` whose product does not divide the ranks
  raise before any rendezvous, also beside the data-parallel flags
  (``tests/test_torch_port_parallel.py`` trains under them).
"""

import json
import os
import random

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from fgt_tpu import data as jdata
from fgt_tpu.core.flow_io import write_flow
from fgt_tpu.train import train as jtrain
from fgt_tpu_torch.train import train as ttrain
from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer
from fgt_tpu_torch.utils.config import dump_yaml, read_yaml

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"lafc_single": "lafc_single_train.yaml",
           "lafc": "lafc_train.yaml", "model": "fgt_train.yaml"}
PORT_ONLY_KEYS = {"device"}
H, W = 48, 64
RES = [32, 32]


@pytest.mark.parametrize("model", sorted(CONFIGS))
def test_build_opt_equals_jax(model):
    argv = ["--model", model, "--opt",
            os.path.join(ROOT, "configs", CONFIGS[model]), "--datadir",
            "/data", "--gen_state", "g.pth"]
    want = jtrain.build_opt(jtrain.args_parser(argv))
    got = ttrain.build_opt(ttrain.args_parser(argv))
    assert set(got) - set(want) == PORT_ONLY_KEYS
    assert set(want) <= set(got)
    for k in want:
        assert got[k] == want[k], k
    assert got["datasets"]["dataInfo"]["frame_path"] == \
        "/data/data/youtubevos_frames"


def _write_tree(root, videos, n, with_masks=False, seed=0):
    rng = np.random.RandomState(seed)
    for v in range(videos):
        name = f"v{v}"
        os.makedirs(root / "frames" / name)
        for d in ("forward_flo", "backward_flo"):
            os.makedirs(root / "flows" / name / d)
        if with_masks:
            os.makedirs(root / "masks" / name)
        for i in range(n):
            imageio.imwrite(root / "frames" / name / f"{i:05d}.png",
                            (rng.rand(H, W, 3) * 255).astype(np.uint8))
            if with_masks:
                m = np.zeros((H, W), np.uint8)
                m[12:30, 16 + i:40 + i] = 255
                imageio.imwrite(root / "masks" / name / f"{i:05d}.png", m)
            if i < n - 1:
                for d in ("forward_flo", "backward_flo"):
                    write_flow(rng.randn(H, W, 2).astype(np.float32) * 2,
                               str(root / "flows" / name / d /
                                   f"{i:05d}.flo"))


TINY = {
    "lafc_single": dict(cnum=8),
    "lafc": dict(cnum=8),
    "model": dict(cnum=8, flow_cnum=8, frame_hidden=32, flow_hidden=16,
                  numBlocks=2, mlp_ratio=2, dist_cnum=8, res_h=32, res_w=32,
                  flow_config={"cnum": 8, "in_channel": 3, "PASSMASK": 1,
                               "use_residual": 1, "resBlocks": 1,
                               "use_bias": 1, "conv_type": "vanilla"}),
}


def _config(tmp, model, steps):
    """The committed config with its data paths, iterations, validation,
    oracle and widths replaced (written with the port's YAML writer)."""
    cfg = read_yaml(os.path.join(ROOT, "configs", CONFIGS[model]))
    cfg.update(TINY[model], outputdir=str(tmp / "out"), mixed_precision=0,
               input_resolution=RES, record_iter=1)
    info = cfg["datasets"]["dataInfo"]
    info.update(frame_path="train/frames", flow_path="train/flows")
    if "flow" in info and model != "model":
        info["flow"] = {"flow_height": RES[0], "flow_width": RES[1]}
    cfg["datasets"]["train"]["n_workers"] = 0
    cfg["datasets"]["valInfo"] = {
        "frame_root": str(tmp / "val" / "frames"),
        "flow_root": str(tmp / "val" / "flows"),
        "mask_root": str(tmp / "val" / "masks"), "num_videos": 2,
        "input_resolution": RES, "flow_mask_rect": 12}
    cfg["train"].update(MAX_ITERS=steps, val_freq=1, log_freq=1)
    if model == "model":
        cfg["flow_checkPoint"] = str(tmp / "out" / "LAFC_single_train" /
                                     "latest" / "model.pth")
    path = tmp / f"{model}.yaml"
    path.write_text(dump_yaml(cfg))
    return str(path)


def _jax_first_batch(argv):
    """The JAX trainer's first batch: its seeding, then its dataset,
    sampler and loader as ``Trainer._prepare_dataset`` builds them."""
    opt = jtrain.build_opt(jtrain.args_parser(argv))
    seed = int(opt.get("seed", 10))
    random.seed(seed)
    np.random.seed(seed)
    dcfg = dict(opt["datasets"].get("train", {}))
    for key in ("num_frames", "num_flows", "flow_interval", "sample",
                "flow_direction", "input_resolution", "norm"):
        if key in opt:
            dcfg.setdefault(key, opt[key])
    name = {"lafc_single": "train_dataset_single_edge",
            "lafc": "train_dataset_edge"}.get(opt["model"], "train_dataset")
    ds = jdata.create_dataset(dcfg, opt["datasets"]["dataInfo"], "train",
                              str(opt.get("datasetName_train") or name))
    sampler = jdata.ShardedSampler(len(ds), shuffle=True, seed=seed)
    sampler.set_epoch(0)
    return next(iter(jdata.create_dataloader("train", ds, dcfg, opt,
                                             sampler)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    _write_tree(tmp / "train", 4, 10)
    _write_tree(tmp / "val", 2, 24, with_masks=True, seed=1)
    firsts, out = {}, {}
    originals = {cls: cls._train_step for cls in (LAFCTrainer, FGTTrainer)}

    def recording(cls):
        def step(self, batch):
            firsts.setdefault(self.run_dir, {k: np.array(v)
                                             for k, v in batch.items()})
            return originals[cls](self, batch)
        return step

    mp = pytest.MonkeyPatch()
    try:
        for cls in originals:
            mp.setattr(cls, "_train_step", recording(cls))
        for model in ("lafc_single", "lafc", "model"):
            argv = ["--model", model, "--opt",
                    _config(tmp, model, 3 if model == "model" else 2),
                    "--datadir", str(tmp)]
            trainer = ttrain.main(argv + ["--device", "cpu", "--use_valid"])
            with open(trainer.metrics.path) as f:
                rows = [json.loads(line) for line in f]
            out[model] = (trainer, rows, firsts[trainer.run_dir],
                          _jax_first_batch(argv))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("model", ["lafc_single", "lafc", "model"])
def test_first_batch_equals_jax_loader(runs, model):
    _, _, got, want = runs[model]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("model", ["lafc_single", "lafc", "model"])
def test_cli_trains_and_validates(runs, model):
    trainer, rows, _, _ = runs[model]
    assert trainer.device == torch.device("cpu")
    steps = [r for r in rows if not any(k.startswith("val/") for k in r)]
    vals = [r for r in rows if any(k.startswith("val/") for k in r)]
    assert [r["step"] for r in steps] == list(
        range(1, trainer.total_iterations + 1))
    loss = "gen_loss" if model == "model" else "loss"
    assert all(np.isfinite(r[loss]) for r in steps)
    assert len(vals) == 1
    for k in ("val/psnr", "val/ssim", "val/l1", "val/l2"):
        assert np.isfinite(vals[0][k]), k
    assert os.listdir(os.path.join(trainer.run_dir, "validation",
                                   "epoch_0"))
    assert os.path.isfile(os.path.join(trainer.run_dir, "latest",
                                       "model.pth"))
    assert trainer.train_loader._pool is None      # workers stopped


def test_fgt_cli_loads_the_lafc_single_oracle(runs):
    trainer = runs["model"][0]
    single = runs["lafc_single"][0]
    want = single.model.state_dict()
    for k, v in trainer.flow_model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_cli_defaults_to_the_card_and_does_not_fall_back(tmp_path):
    args = ttrain.args_parser(["--model", "lafc"])
    assert args.device == "cuda"
    tmp = tmp_path
    _write_tree(tmp / "train", 4, 10)
    argv = ["--model", "lafc_single", "--opt",
            _config(tmp, "lafc_single", 1), "--datadir", str(tmp)]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises((RuntimeError, AssertionError)):
        ttrain.main(argv)


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--sp", "2"],
                                   ["--tp", "2", "--sp", "2",
                                    "--coordinator", "localhost:1234",
                                    "--num_processes", "2",
                                    "--process_id", "0"]])
def test_multi_device_flags_raise(flags):
    """A tensor- and sequence-parallel grid larger than the ranks raises
    before a group is made (no rendezvous is attempted:
    ``tests/test_torch_port_parallel.py`` trains under ``--tp``/``--sp``
    in a group that has the ranks)."""
    with pytest.raises(ValueError, match="does not divide"):
        ttrain.main(["--model", "lafc", "--device", "cpu"] + flags)
