"""Training orchestration — counterpart of ``fgt_tpu/train/trainer.py``
(``MetricsWriter``, the base loop, ``LAFCTrainer`` for stage 1 and
``FGTTrainer`` for stage 2), which replaces the reference's
Trainer/Network split (FGT/trainer.py:14-199, FGT/networks/network.py:
21-491, LAFC/networks/network.py).

* Data: with ``opt['datasets']['dataInfo']`` the trainer builds the
  dataset named by ``datasetName_train`` (or the stage's default), a
  shuffling ``ShardedSampler`` seeded from ``seed`` and the prefetching
  loader (``opt['datasets']['train']``: batch_size, n_workers), and
  :meth:`Trainer.train` steps over it epoch by epoch. An iterable of
  batches given to :meth:`Trainer.train` takes its place (each pass is
  one epoch). Training runs until ``train.MAX_ITERS``.
* Validation: with ``use_valid``, every ``train.val_freq`` epochs, on
  the ``opt['datasets']['valInfo']`` tree (``train/validate.py``);
  scores go to the metrics stream as ``val/*``.
* Metrics: a JSONL stream (always) plus TensorBoard when
  ``torch.utils.tensorboard`` imports; logged values are running means
  over the last ``record_iter`` logs, reset every ``record_iter`` logs
  (reference ``_printLog``, network.py:184-206).
* Checkpoints: the gen / dist / opt trio (gen / opt for LAFC) with the
  reference's name pattern and resume / finetune semantics
  (network.py:51-78, 225-256), plus a ``latest`` model directory for
  the inference CLI.
* Stage 2's frozen flow oracle (``flow_checkPoint``, built from
  ``flow_config``): a LAFC-single ``state_dict`` file (a port run's
  ``latest/model.pth``) or the JAX package's ``model.msgpack`` (a JAX
  run's ``latest/``, as ``configs/fgt_train.yaml`` names it).

Data parallelism (the JAX trainer's ``dp`` axis): when a process group
of N ranks is initialised (``utils/dist.py``; the training CLI makes one
from ``--coordinator``), every rank builds the same models, takes rank
0's parameters, loads shard ``rank`` of N of the sampler with
``batch_size`` items a step (the global batch is ``batch_size`` x N, as
the JAX trainer's per-device batch) and steps on it; the steps average
the gradients over the ranks. Rank 0 alone archives and writes the run
directory, the log file, the metrics (means over the ranks), the
checkpoints and the validation. Resume loads on every rank.

Tensor and sequence parallelism (the JAX trainer's ``tp`` and ``sp``
mesh axes; ``opt['tp']``, ``opt['sp']``): the ranks form a (dp, tp, sp)
grid (``parallel/mesh.py``). The sampler shards by the dp coordinate,
and the data's random draws are seeded by it, so every tp and sp rank of
one dp group loads the same items and masks. ``FGTTrainer`` builds the
generator from the full init on every rank, then shards it and its Adam
state over tp and its frames over sp (``parallel/partition.py``); the
losses' normalisers, the gradient average and the metrics use the dp
group. LAFC, LAFC-single and the discriminator are replicated across tp
and sp. Checkpoints hold the full state dicts (the files one process
writes), gathered from the tp ranks; resume shards them again.
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
from fgt_tpu_torch.convert.weights import load_state, load_weights
from fgt_tpu_torch.models import fgt as fgt_mod
from fgt_tpu_torch.models import lafc, lafc_single
from fgt_tpu_torch.models.discriminator import (TemporalPatchGAN,
                                                init_discriminator)
from fgt_tpu_torch.parallel import partition
from fgt_tpu_torch.parallel.mesh import make_mesh
from fgt_tpu_torch.train.fgt_step import FGTLossWeights, FGTTrainStep
from fgt_tpu_torch.train.lafc_step import LAFCLossWeights, LAFCTrainStep
from fgt_tpu_torch.train.schedules import make_adam, warmup_step_decay
from fgt_tpu_torch.utils import checkpoint
from fgt_tpu_torch.utils import dist


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
        self.rank, self.num_ranks = dist.rank(), dist.world_size()
        self.mesh = make_mesh(tp=int(opt.get("tp", 1) or 1),
                              sp=int(opt.get("sp", 1) or 1))
        self.dp_index, self.dp_group = (self.mesh.index("dp"),
                                        self.mesh.group("dp"))
        # the schedule's warmup rule reads world_size (the JAX trainer's)
        self.world_size = int(opt.get("world_size") or self.num_ranks)
        name = opt.get("name", self.model_kind)
        out_root = opt.get("outputdir", opt.get("output_dir", "outputs"))
        self.run_dir = os.path.join(out_root, name)
        self.metrics = None
        if self.rank == 0:
            if not opt.get("resume"):
                archive_existing_dir(self.run_dir)
            os.makedirs(self.run_dir, exist_ok=True)
            self.logger = setup_logger("fgt_tpu_torch.train", self.run_dir)
            with open(os.path.join(self.run_dir, "config_snapshot.json"),
                      "w") as f:
                json.dump({k: str(v) for k, v in opt.items()}, f, indent=2)
            self.metrics = MetricsWriter(os.path.join(self.run_dir, "tb"))
            if self.num_ranks > 1:
                self.logger.info("%d ranks: dp %d x tp %d x sp %d",
                                 self.num_ranks, self.mesh.dp, self.mesh.tp,
                                 self.mesh.sp)
        else:
            self.logger = setup_logger(f"fgt_tpu_torch.train.{self.rank}")

        seed = int(opt.get("seed", 10))
        # the data's draws follow the dp coordinate; the init does not
        random.seed(seed + self.dp_index)
        np.random.seed(seed + self.dp_index)
        self.init_gen = torch.Generator().manual_seed(seed)
        self.val_info = opt.get("datasets", {}).get("valInfo")
        self.train_loader = None
        if opt.get("datasets", {}).get("dataInfo"):
            self._prepare_dataset()
        self.total_iterations = int(opt["train"]["MAX_ITERS"])
        self.current_step = 0
        self.start_epoch = 0
        self.sched = None

    # ---------------- data ----------------

    def _dataset_name(self) -> str:
        raise NotImplementedError

    def _prepare_dataset(self) -> None:
        """The dataset, sampler and loader of ``opt['datasets']`` (JAX
        ``Trainer._prepare_dataset``): the shard of this rank's dp
        coordinate, ``batch_size`` items a step, the items' draws seeded
        by the coordinate."""
        from fgt_tpu_torch.data import (ShardedSampler, create_dataloader,
                                        create_dataset)

        opt = self.opt
        dcfg = dict(opt["datasets"].get("train", {}))
        for key in ("num_frames", "num_flows", "flow_interval", "sample",
                    "flow_direction", "input_resolution", "norm"):
            if key in opt:
                dcfg.setdefault(key, opt[key])
        ds_name = str(opt.get("datasetName_train") or self._dataset_name())
        self.train_set = create_dataset(dcfg, opt["datasets"]["dataInfo"],
                                        "train", ds_name)
        seed = int(opt.get("seed", 10))
        self.sampler = ShardedSampler(len(self.train_set),
                                      shard=self.dp_index,
                                      num_shards=self.mesh.dp, shuffle=True,
                                      seed=seed)
        self.train_loader = create_dataloader(
            "train", self.train_set, dcfg,
            dict(opt, seed=seed + self.dp_index), self.sampler)
        self.logger.info("videos: %d, iters/epoch: %d, batch: %d, "
                         "workers: %d", len(self.train_set),
                         len(self.train_loader),
                         self.train_loader.batch_size,
                         self.train_loader.num_workers)

    def train(self, batches: Optional[Iterable[dict]] = None) -> None:
        """Steps over the dataset's loader (``batches`` None) or over
        ``batches``, epoch after epoch, until ``total_iterations``; an
        epoch that yields nothing ends training. The loader's workers
        are stopped on return."""
        loader = self.train_loader if batches is None else None
        if batches is None and loader is None:
            raise ValueError("train(): no batches given and no dataset "
                             "(opt['datasets']['dataInfo']) to load")
        tr = self.opt.get("train", {})
        log_freq = int(tr.get("log_freq", self.opt.get("PRINT_INFO_FREQ",
                                                       100)))
        save_freq = int(tr.get("save_checkpoint_freq",
                               self.opt.get("SAVE_CHECKPOINT_FREQ", 5000)))
        val_freq = int(tr.get("val_freq", 1))
        use_valid = bool(self.opt.get("use_valid", False))
        record_iter = max(1, int(self.opt.get("record_iter", 16)))
        run_sum: dict = {}
        run_n = 0
        try:
            for epoch in itertools.count(self.start_epoch):
                if loader is not None:
                    self.sampler.set_epoch(epoch)
                t0 = time.time()
                seen = 0
                for batch in (loader if loader is not None else batches):
                    if self.current_step >= self.total_iterations:
                        break
                    seen += 1
                    self.current_step += 1
                    metrics = self._train_step(batch)
                    if self.current_step % log_freq == 0:
                        scalars = dist.mean_scalars(metrics, self.dp_group)
                        scalars["it_per_s"] = log_freq / max(
                            time.time() - t0, 1e-9)
                        if self.sched is not None:
                            scalars["lr"] = float(
                                self.sched(self.current_step))
                        t0 = time.time()
                        if run_n >= record_iter:
                            run_sum, run_n = {}, 0
                        run_n += 1
                        for k, v in scalars.items():
                            run_sum[k] = run_sum.get(k, 0.0) + v
                        means = {k: v / run_n for k, v in run_sum.items()}
                        if self.metrics is not None:
                            self.metrics.write(self.current_step, means)
                        self.logger.info(
                            "[epoch %d step %d] %s", epoch,
                            self.current_step,
                            " ".join(f"{k}:{v:.4f}"
                                     for k, v in means.items()))
                    if self.current_step % save_freq == 0:
                        self.save_checkpoint(epoch)
                if seen == 0 or self.current_step >= self.total_iterations:
                    break
                if use_valid and (epoch + 1) % val_freq == 0:
                    self._validate(epoch)
        finally:
            if loader is not None:
                loader.close()
        self.save_checkpoint(epoch)
        self.logger.info("Train process has been finished")

    def _write_val(self, epoch: int, scores: dict) -> None:
        if not scores:
            return
        self.metrics.write(self.current_step,
                           {f"val/{k}": v for k, v in scores.items()})
        self.logger.info("[val epoch %d] %s", epoch,
                         " ".join(f"{k}:{v:.4f}" for k, v in scores.items()))

    def _val_dir(self, epoch: int) -> str:
        return os.path.join(self.run_dir, "validation", f"epoch_{epoch}")

    def _val_resolution(self) -> tuple:
        vi = self.val_info or {}
        return tuple(vi.get("input_resolution",
                            self.opt.get("input_resolution", (240, 432))))

    def _train_step(self, batch: dict) -> dict:
        raise NotImplementedError

    def save_checkpoint(self, epoch: int) -> dict:
        raise NotImplementedError

    def _validate(self, epoch: int) -> None:
        """Called on every rank; rank 0 validates and writes."""
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
        dist.broadcast_module(self.model)
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
            single=self.single, group=self.dp_group)
        if opt.get("path", {}).get("gen_state"):
            self._resume(opt["path"])

    def _dataset_name(self) -> str:
        return ("train_dataset_single_edge" if self.single
                else "train_dataset_edge")

    def _validate(self, epoch: int) -> None:
        """Flow-domain validation (reference LAFC network.py:271-373)."""
        from fgt_tpu_torch.train.validate import validate_lafc

        if self.rank != 0:
            return
        vi = self.val_info or {}
        flow_root = vi.get("flow_root", vi.get("flow_path"))
        if not flow_root or not os.path.isdir(flow_root):
            self.logger.info("validation skipped: no val flows at %s",
                             flow_root)
            return
        self._write_val(epoch, validate_lafc(
            self.model, flow_root, num_videos=int(vi.get("num_videos", 10)),
            resolution=self._val_resolution(),
            mask_size=int(vi.get("flow_mask_rect", 96)),
            num_flows=int(self.opt.get("num_flows", 3)),
            interval=int(self.opt.get("flow_interval", 3)),
            single=self.single, save_dir=self._val_dir(epoch)))

    def _train_step(self, batch: dict) -> dict:
        b = {k: torch.as_tensor(v).to(self.device, torch.float32)
             for k, v in batch.items() if k != "flow_gray"}
        if self.single:     # lift 4-D single-flow items to a T = 1 window
            for k in ("flows", "diffused_flows", "masks"):
                if b[k].dim() == 4:
                    b[k] = b[k][:, None]
        return self.lafc_step(b)

    def save_checkpoint(self, epoch: int) -> dict:
        """Write the gen / opt pair (rank 0); returns its paths under the
        ``opt['path']`` keys that :meth:`_resume` reads."""
        paths = {"gen_state": self._ckpt_path("gen", epoch),
                 "opt_state": self._ckpt_path("opt", epoch)}
        if self.rank != 0:
            return paths
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
        sp = self.mesh.sp > 1
        self.gen = fgt_mod.init_fgt(
            fgt_mod.Model(dict(opt, seq_axis="sp") if sp else opt),
            self.init_gen)
        self.disc = init_discriminator(
            TemporalPatchGAN(3, int(opt.get("dist_cnum", 32))),
            self.init_gen)
        self.gen.to(self.device)
        self.disc.to(self.device)
        dist.broadcast_module(self.gen)
        dist.broadcast_module(self.disc)
        # full-shape specs of the generator's leaves (None: not sharded)
        self.gen_specs = None
        if self.mesh.tp > 1 or sp:
            self.logger.info("generator: %.3f of its parameters tp-sharded",
                             partition.tp_param_fraction(
                                 self.gen.state_dict(), self.mesh.tp))
            self.gen_specs = partition.shard_module(self.gen, self.mesh)
        self.sched = warmup_step_decay(
            float(tr["lr"]), decay_interval=int(tr["UPDATE_INTERVAL"]),
            gamma=float(tr.get("lr_decay", 0.1)), warmup=tr.get("WARMUP"),
            world_size=self.world_size)
        betas = float(tr.get("BETA1", 0.9)), float(tr.get("BETA2", 0.999))
        self.g_opt = make_adam(self.gen.parameters(), *betas)
        self.d_opt = make_adam(self.disc.parameters(), *betas)

        self.flow_model = None
        if opt.get("flow_checkPoint"):
            flow_config = opt.get("flow_config", {})
            self.flow_model = lafc_single.Model(flow_config)
            load_state(self.flow_model, load_weights(
                opt["flow_checkPoint"], "lafc_single", flow_config))
            self.flow_model.to(self.device).eval().requires_grad_(False)

        weights = FGTLossWeights(
            L1M=float(tr.get("L1M", 1.0)), L1V=float(tr.get("L1V", 1.0)),
            adv=float(tr.get("adv", 0.01)),
            gan_kind=str(tr.get("gan_type", "hinge")))
        self.gan_step = FGTTrainStep(
            self.gen, self.disc, self.flow_model, self.g_opt, self.d_opt,
            self.sched, weights, bi_mode=self.bi_mode,
            mixed_precision=bool(int(opt.get("mixed_precision", 0))),
            group=self.dp_group,
            sp_group=self.mesh.group("sp") if sp else None)
        if opt.get("path", {}).get("gen_state"):
            self._resume(opt["path"])

    def _dataset_name(self) -> str:
        return "train_dataset"

    def _validate(self, epoch: int) -> None:
        """DAVIS-protocol validation (FGT/networks/network.py:258-354),
        with the frozen oracle completing the flows. The valInfo's
        ``mask_root`` is read (the JAX trainer leaves it unread and
        always validates on the centered square)."""
        from fgt_tpu_torch.train.validate import validate_fgt

        gen = self.full_generator()
        if self.rank != 0:
            return
        vi = self.val_info or {}
        frame_root = vi.get("frame_root", vi.get("frame_path"))
        if not frame_root or not os.path.isdir(frame_root):
            self.logger.info("validation skipped: no val data at %s",
                             frame_root)
            return
        self._write_val(epoch, validate_fgt(
            gen, frame_root, vi.get("flow_root", vi.get("flow_path")),
            flow_model=self.flow_model, mask_root=vi.get("mask_root"),
            num_videos=int(vi.get("num_videos", 10)),
            resolution=self._val_resolution(),
            mask_size=int(vi.get("flow_mask_rect", 96)),
            pivot=int(vi.get("pivot", 20)),
            num_frames=int(self.opt.get("num_frames", 5)),
            save_dir=self._val_dir(epoch)))

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
        """Write the trio (rank 0); returns its paths under the
        ``opt['path']`` keys that :meth:`_resume` reads."""
        paths = {"gen_state": self._ckpt_path("gen", epoch),
                 "dis_state": self._ckpt_path("dist", epoch),
                 "opt_state": self._ckpt_path("opt", epoch)}
        gen_state, g_opt_state = self.full_state()
        if self.rank != 0:
            return paths
        checkpoint.save(gen_state, paths["gen_state"])
        checkpoint.save(self.disc.state_dict(), paths["dis_state"])
        checkpoint.save({"epoch": epoch, "iteration": self.current_step,
                         "g_opt": g_opt_state,
                         "d_opt": self.d_opt.state_dict()},
                        paths["opt_state"])
        cfg = {k: v for k, v in self.opt.items()
               if isinstance(v, (int, float, str, bool, list, tuple))}
        cfg["model"] = "model"
        checkpoint.save_model_dir(gen_state, cfg,
                                  os.path.join(self.run_dir, "latest"))
        self.logger.info("checkpoint trio saved at step %d",
                         self.current_step)
        return paths

    def _sharded(self) -> bool:
        return self.gen_specs is not None and self.mesh.tp > 1

    def full_state(self) -> tuple:
        """(the generator's state dict, its Adam state dict) at full
        shapes: gathered from the tp ranks when the generator is
        sharded (every rank must call it then)."""
        gen, g_opt = self.gen.state_dict(), self.g_opt.state_dict()
        if self._sharded():
            gen = partition.gather_state(gen, self.mesh, self.gen_specs)
            g_opt = partition.gather_optimizer_state(
                g_opt, [n for n, _ in self.gen.named_parameters()],
                self.mesh, self.gen_specs)
        return gen, g_opt

    def full_generator(self) -> torch.nn.Module:
        """The generator, or under tensor or sequence parallelism an
        unsharded copy of it on this rank's device (every rank must
        call it then)."""
        if self.gen_specs is None:
            return self.gen
        gen = fgt_mod.Model(self.opt)
        load_state(gen, self.full_state()[0])
        return gen.to(self.device)

    def _resume(self, paths: dict) -> None:
        state = checkpoint.load_state_dict(paths["gen_state"])
        if self._sharded():
            state = partition.shard_state(state, self.mesh, self.gen_specs)
        load_state(self.gen, state)
        if paths.get("dis_state"):
            load_state(self.disc,
                       checkpoint.load_state_dict(paths["dis_state"]))
        if paths.get("opt_state") and not self.opt.get("finetune"):
            st = checkpoint.load(paths["opt_state"])
            self.start_epoch = int(st["epoch"])
            self.current_step = int(st["iteration"])
            g_opt = st["g_opt"]
            if self._sharded():
                g_opt = partition.shard_optimizer_state(
                    g_opt, [n for n, _ in self.gen.named_parameters()],
                    self.mesh, self.gen_specs)
            self.g_opt.load_state_dict(g_opt)
            self.d_opt.load_state_dict(st["d_opt"])
        self.gan_step.step = self.current_step
        self.logger.info("resumed from %s (finetune=%s)", paths["gen_state"],
                         self.opt.get("finetune"))
