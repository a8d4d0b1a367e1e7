"""Training orchestration — counterpart of ``fgt_tpu/train/trainer.py``
(``MetricsWriter``, the base loop, ``LAFCTrainer`` for stage 1 and
``FGTTrainer`` for stage 2), which replaces the reference's
Trainer/Network split (FGT/trainer.py:14-199, FGT/networks/network.py:
21-491, LAFC/networks/network.py).

* The loop takes an iterable of batches (each pass over it is one
  epoch) in place of the JAX package's dataset and loader, which wait
  for training data in the repo; it runs until ``train.MAX_ITERS``.
* Metrics: a JSONL stream (always) plus TensorBoard when
  ``torch.utils.tensorboard`` imports; logged values are running means
  over the last ``record_iter`` logs, reset every ``record_iter`` logs
  (reference ``_printLog``, network.py:184-206).
* Checkpoints: the gen / dist / opt trio (gen / opt for LAFC) with the
  reference's name pattern and resume / finetune semantics
  (network.py:51-78, 225-256), plus a ``latest`` model directory for
  the inference CLI.

One device, no mesh: data, tensor and sequence parallelism wait for the
multi-GPU slice. In-training validation waits for validation data.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import random
import time
from typing import Iterable, Optional

import numpy as np
import torch

from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.convert.weights import load_state
from fgt_tpu_torch.models import fgt as fgt_mod
from fgt_tpu_torch.models import lafc, lafc_single
from fgt_tpu_torch.models.discriminator import (TemporalPatchGAN,
                                                init_discriminator)
from fgt_tpu_torch.train.fgt_step import FGTLossWeights, FGTTrainStep
from fgt_tpu_torch.train.lafc_step import LAFCLossWeights, LAFCTrainStep
from fgt_tpu_torch.train.schedules import make_adam, warmup_step_decay
from fgt_tpu_torch.utils import checkpoint


def setup_logger(name: str, log_dir: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S")
    handlers = [logging.StreamHandler()]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%y%m%d-%H%M%S")
        handlers.append(logging.FileHandler(
            os.path.join(log_dir, f"run_{stamp}.log")))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def archive_existing_dir(path: str) -> None:
    """Rename an existing output dir to ``<path>_archived_<ts>``
    (reference FGT/utils/util.py:66-74)."""
    if os.path.exists(path):
        os.rename(path, f"{path}_archived_{time.strftime('%Y%m%d-%H%M%S')}")


class MetricsWriter:
    """JSONL metrics stream + optional TensorBoard twin."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._tb = None

    def write(self, step: int, scalars: dict) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)


class Trainer:
    """Epoch loop + run-dir management."""

    model_kind = "base"

    def __init__(self, opt: dict, device: str = DEFAULT_DEVICE):
        self.opt = opt
        self.device = torch.device(device)
        self.world_size = int(opt.get("world_size") or 1)
        name = opt.get("name", self.model_kind)
        out_root = opt.get("outputdir", opt.get("output_dir", "outputs"))
        self.run_dir = os.path.join(out_root, name)
        if not opt.get("resume"):
            archive_existing_dir(self.run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.logger = setup_logger("fgt_tpu_torch.train", self.run_dir)
        with open(os.path.join(self.run_dir, "config_snapshot.json"),
                  "w") as f:
            json.dump({k: str(v) for k, v in opt.items()}, f, indent=2)
        self.metrics = MetricsWriter(os.path.join(self.run_dir, "tb"))

        seed = int(opt.get("seed", 10))
        random.seed(seed)
        np.random.seed(seed)
        self.init_gen = torch.Generator().manual_seed(seed)
        self.total_iterations = int(opt["train"]["MAX_ITERS"])
        self.current_step = 0
        self.start_epoch = 0
        self.sched = None

    def train(self, batches: Iterable[dict]) -> None:
        """Steps over ``batches``, pass after pass, until
        ``total_iterations``; a pass that yields nothing ends training."""
        tr = self.opt.get("train", {})
        log_freq = int(tr.get("log_freq", self.opt.get("PRINT_INFO_FREQ",
                                                       100)))
        save_freq = int(tr.get("save_checkpoint_freq",
                               self.opt.get("SAVE_CHECKPOINT_FREQ", 5000)))
        record_iter = max(1, int(self.opt.get("record_iter", 16)))
        run_sum: dict = {}
        run_n = 0
        for epoch in itertools.count(self.start_epoch):
            t0 = time.time()
            seen = 0
            for batch in batches:
                if self.current_step >= self.total_iterations:
                    break
                seen += 1
                self.current_step += 1
                metrics = self._train_step(batch)
                if self.current_step % log_freq == 0:
                    scalars = {k: float(v) for k, v in metrics.items()}
                    scalars["it_per_s"] = log_freq / max(time.time() - t0,
                                                         1e-9)
                    if self.sched is not None:
                        scalars["lr"] = float(self.sched(self.current_step))
                    t0 = time.time()
                    if run_n >= record_iter:
                        run_sum, run_n = {}, 0
                    run_n += 1
                    for k, v in scalars.items():
                        run_sum[k] = run_sum.get(k, 0.0) + v
                    means = {k: v / run_n for k, v in run_sum.items()}
                    self.metrics.write(self.current_step, means)
                    self.logger.info(
                        "[epoch %d step %d] %s", epoch, self.current_step,
                        " ".join(f"{k}:{v:.4f}" for k, v in means.items()))
                if self.current_step % save_freq == 0:
                    self.save_checkpoint(epoch)
            if seen == 0 or self.current_step >= self.total_iterations:
                break
        self.save_checkpoint(epoch)
        self.logger.info("Train process has been finished")

    def _train_step(self, batch: dict) -> dict:
        raise NotImplementedError

    def save_checkpoint(self, epoch: int) -> dict:
        raise NotImplementedError

    def _ckpt_path(self, tag: str, epoch: int) -> str:
        return os.path.join(self.run_dir, "checkpoints",
                            f"{tag}_{epoch}_{self.current_step}.pth")


class LAFCTrainer(Trainer):
    """Stage-1 flow completion: the multi-flow P3D LAFC, or with
    ``single`` (or ``opt['model'] == 'lafc_single'``) the 2D LAFC-single,
    which trains on the pivot flow only and serves stage 2 as its frozen
    flow oracle.

    ``opt`` holds the keys of ``configs/lafc_train.yaml`` or
    ``configs/lafc_single_train.yaml`` as a dict: the model config at
    top level, ``mixed_precision``, ``gc`` (global-norm clip at 10),
    ``train`` (lr, betas, schedule, loss weights L1M / sm / sm2 /
    ternary / edge_loss, MAX_ITERS, log and save frequencies) and
    ``path`` (gen_state / opt_state) to resume. Batches hold flows and
    diffused_flows [B, T, H, W, 2], masks [B, T, H, W, 1], edges
    [B, H, W, 1], current_frame and shift_frame [B, H, W, 3] in [0, 1],
    as numpy arrays or tensors; LAFC-single items may be 4-D
    (no T axis)."""

    model_kind = "lafc"

    def __init__(self, opt: dict, device: str = DEFAULT_DEVICE,
                 single: bool = False):
        self.single = single or str(opt.get("model", "")) == "lafc_single"
        super().__init__(opt, device)
        tr = opt["train"]
        if self.single:
            self.model = lafc_single.init_lafc_single(
                lafc_single.Model(opt), self.init_gen)
        else:
            self.model = lafc.init_lafc(lafc.Model(opt), self.init_gen)
        self.model.to(self.device)
        self.sched = warmup_step_decay(
            float(tr["lr"]), decay_interval=int(tr["UPDATE_INTERVAL"]),
            gamma=float(tr.get("lr_decay", 0.1)), warmup=tr.get("WARMUP"),
            world_size=self.world_size)
        self.optimizer = make_adam(self.model.parameters(),
                                   float(tr.get("BETA1", 0.9)),
                                   float(tr.get("BETA2", 0.999)))
        weights = LAFCLossWeights(
            L1M=float(tr.get("L1M", 1.0)), sm=float(tr.get("sm", 1.0)),
            sm2=float(tr.get("sm2", 1.0)),
            ternary=float(tr.get("ternary", 0.01)),
            edge=float(tr.get("edge_loss", 1.0)))
        self.lafc_step = LAFCTrainStep(
            self.model, self.optimizer, self.sched, weights,
            grad_clip=10.0 if opt.get("gc") else None,
            mixed_precision=bool(int(opt.get("mixed_precision", 0))),
            single=self.single)
        if opt.get("path", {}).get("gen_state"):
            self._resume(opt["path"])

    def _train_step(self, batch: dict) -> dict:
        b = {k: torch.as_tensor(v).to(self.device, torch.float32)
             for k, v in batch.items() if k != "flow_gray"}
        if self.single:     # lift 4-D single-flow items to a T = 1 window
            for k in ("flows", "diffused_flows", "masks"):
                if b[k].dim() == 4:
                    b[k] = b[k][:, None]
        return self.lafc_step(b)

    def save_checkpoint(self, epoch: int) -> dict:
        """Write the gen / opt pair; returns its paths under the
        ``opt['path']`` keys that :meth:`_resume` reads."""
        paths = {"gen_state": self._ckpt_path("gen", epoch),
                 "opt_state": self._ckpt_path("opt", epoch)}
        checkpoint.save(self.model.state_dict(), paths["gen_state"])
        checkpoint.save({"epoch": epoch, "iteration": self.current_step,
                         "optimizer": self.optimizer.state_dict()},
                        paths["opt_state"])
        cfg = {k: v for k, v in self.opt.items()
               if isinstance(v, (int, float, str, bool, list, tuple))}
        cfg["model"] = "lafc_single" if self.single else "lafc"
        checkpoint.save_model_dir(self.model.state_dict(), cfg,
                                  os.path.join(self.run_dir, "latest"))
        self.logger.info("checkpoint saved at step %d", self.current_step)
        return paths

    def _resume(self, paths: dict) -> None:
        load_state(self.model, checkpoint.load_state_dict(paths["gen_state"]))
        if paths.get("opt_state") and not self.opt.get("finetune"):
            st = checkpoint.load(paths["opt_state"])
            self.start_epoch = int(st["epoch"])
            self.current_step = int(st["iteration"])
            self.optimizer.load_state_dict(st["optimizer"])
        self.lafc_step.step = self.current_step
        self.logger.info("resumed from %s (finetune=%s)", paths["gen_state"],
                         self.opt.get("finetune"))


class FGTTrainer(Trainer):
    """Stage-2 GAN training of the FGT generator with a frozen
    LAFC-single flow oracle (reference FGT/networks/network.py:21-223).

    ``opt`` holds the keys of ``configs/fgt_train.yaml`` as a dict: the
    generator config at top level, ``dist_cnum``, ``mixed_precision``,
    ``train`` (lr, betas, schedule, loss weights, MAX_ITERS, log and
    save frequencies), ``flow_checkPoint`` + ``flow_config`` for the
    oracle, and ``path`` (gen_state / dis_state / opt_state) to resume.
    Batches hold frames [B, T, H, W, 3] in [-1, 1], masks
    [B, T, H, W, 1] and ``forward_flo`` and/or ``backward_flo``
    [B, T, H, W, 2], as numpy arrays or tensors."""

    model_kind = "fgt"

    def __init__(self, opt: dict, device: str = DEFAULT_DEVICE):
        # 'bi' trains on both flow directions (see fgt_step); opt['bi_mode']
        # picks 'fuse' (default) or 'alternate'
        self.bi_mode = (str(opt.get("bi_mode", "fuse"))
                        if str(opt.get("flow_direction", "for")) == "bi"
                        else None)
        super().__init__(opt, device)
        tr = opt["train"]
        self.gen = fgt_mod.init_fgt(fgt_mod.Model(opt), self.init_gen)
        self.disc = init_discriminator(
            TemporalPatchGAN(3, int(opt.get("dist_cnum", 32))),
            self.init_gen)
        self.gen.to(self.device)
        self.disc.to(self.device)
        self.sched = warmup_step_decay(
            float(tr["lr"]), decay_interval=int(tr["UPDATE_INTERVAL"]),
            gamma=float(tr.get("lr_decay", 0.1)), warmup=tr.get("WARMUP"),
            world_size=self.world_size)
        betas = float(tr.get("BETA1", 0.9)), float(tr.get("BETA2", 0.999))
        self.g_opt = make_adam(self.gen.parameters(), *betas)
        self.d_opt = make_adam(self.disc.parameters(), *betas)

        self.flow_model = None
        if opt.get("flow_checkPoint"):
            self.flow_model = lafc_single.Model(opt.get("flow_config", {}))
            load_state(self.flow_model,
                       checkpoint.load_state_dict(opt["flow_checkPoint"]))
            self.flow_model.to(self.device).eval().requires_grad_(False)

        weights = FGTLossWeights(
            L1M=float(tr.get("L1M", 1.0)), L1V=float(tr.get("L1V", 1.0)),
            adv=float(tr.get("adv", 0.01)),
            gan_kind=str(tr.get("gan_type", "hinge")))
        self.gan_step = FGTTrainStep(
            self.gen, self.disc, self.flow_model, self.g_opt, self.d_opt,
            self.sched, weights, bi_mode=self.bi_mode,
            mixed_precision=bool(int(opt.get("mixed_precision", 0))))
        if opt.get("path", {}).get("gen_state"):
            self._resume(opt["path"])

    def _train_step(self, batch: dict) -> dict:
        b = {"frames": batch["frames"], "masks": batch["masks"]}
        if self.bi_mode:
            b["flows_fwd"] = batch["forward_flo"]
            b["flows_bwd"] = batch["backward_flo"]
        else:
            b["flows"] = batch.get("forward_flo", batch.get("backward_flo"))
        b = {k: torch.as_tensor(v).to(self.device, torch.float32)
             for k, v in b.items()}
        return self.gan_step(b)

    def save_checkpoint(self, epoch: int) -> dict:
        """Write the trio; returns its paths under the ``opt['path']``
        keys that :meth:`_resume` reads."""
        paths = {"gen_state": self._ckpt_path("gen", epoch),
                 "dis_state": self._ckpt_path("dist", epoch),
                 "opt_state": self._ckpt_path("opt", epoch)}
        checkpoint.save(self.gen.state_dict(), paths["gen_state"])
        checkpoint.save(self.disc.state_dict(), paths["dis_state"])
        checkpoint.save({"epoch": epoch, "iteration": self.current_step,
                         "g_opt": self.g_opt.state_dict(),
                         "d_opt": self.d_opt.state_dict()},
                        paths["opt_state"])
        cfg = {k: v for k, v in self.opt.items()
               if isinstance(v, (int, float, str, bool, list, tuple))}
        cfg["model"] = "model"
        checkpoint.save_model_dir(self.gen.state_dict(), cfg,
                                  os.path.join(self.run_dir, "latest"))
        self.logger.info("checkpoint trio saved at step %d",
                         self.current_step)
        return paths

    def _resume(self, paths: dict) -> None:
        load_state(self.gen, checkpoint.load_state_dict(paths["gen_state"]))
        if paths.get("dis_state"):
            load_state(self.disc,
                       checkpoint.load_state_dict(paths["dis_state"]))
        if paths.get("opt_state") and not self.opt.get("finetune"):
            st = checkpoint.load(paths["opt_state"])
            self.start_epoch = int(st["epoch"])
            self.current_step = int(st["iteration"])
            self.g_opt.load_state_dict(st["g_opt"])
            self.d_opt.load_state_dict(st["d_opt"])
        self.gan_step.step = self.current_step
        self.logger.info("resumed from %s (finetune=%s)", paths["gen_state"],
                         self.opt.get("finetune"))
