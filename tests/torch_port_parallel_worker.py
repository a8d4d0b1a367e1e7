"""One rank of a tensor- or sequence-parallel run of the port's FGT, for
``tests/test_torch_port_parallel.py`` (on the CPU) and ``chip_smoke.py``
(two ranks on one card):

    python tests/torch_port_parallel_worker.py RANK SPEC.json [SPEC.json ...]

runs each SPEC in turn (one process start for several runs). A SPEC
holds ``job``, ``world``, ``address`` (host:port of the rendezvous),
``tp``, ``sp``, ``device`` ("cpu", or "cuda:0" for every rank), ``out``
(a directory) and ``name`` (the run's file stem), and per job:

* ``forward``: ``config`` (the FGT model config), ``state`` (a saved
  full state dict), ``inputs`` (an ``.npz`` of frames, flows, masks);
  the generator is built, loaded, sharded over the (dp, tp, sp) mesh and
  run once without gradients; saves ``{name}_rank{RANK}.pt``: its
  output;
* ``gan_step``: ``config`` (the generator's), ``states`` (saved full
  state dicts of ``gen``, ``disc``, ``oracle``), ``oracle_config``,
  ``dist_cnum``, ``batch`` (an ``.npz``), ``optimizer`` ("sgd": one step
  at lr 0.5, "adam": three steps of the trainer's Adam on a warmup
  schedule, alternating flow directions); saves every step's metrics,
  the gathered generator, the discriminator and this rank's own
  generator leaves;
* ``train``: ``opt`` (``FGTTrainer``'s options, or ``LAFCTrainer``'s
  with ``kind`` "lafc_single") and ``batches`` (an ``.npz`` of global
  batches, keys ``{step}/{name}``): the trainer trains on this rank's
  dp share of each batch; saves the gathered generator, this rank's own
  models and their parameter bytes, the run directory, and the flash
  kernels' launches and (entry, N, L) shapes;
* ``sampler``: ``opt`` with a ``datasets`` block: saves the first batch
  of this rank's loader and its sampler's indices;
* ``inference``: ``argv`` (the inference CLI's flags, ``--dp``, ``--tp``
  or ``--sp`` among them) and ``passes``: the CLI's models
  (``build_models``) and its load-and-inpaint step
  (``inpaint_from_args``), run ``passes`` times; saves the output, each
  pass's stage seconds, launches of K1 and K2, K2's (N, L) and peak
  memory, and the FGT parameter bytes this rank holds.

On the card every rank runs with cuDNN's deterministic algorithms, so
the replicated computations of the ranks agree bit for bit.

Each rank joins a gloo group (NCCL refuses two ranks on one card).
TF32 is off. Imports torch and the port only.
"""

import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fgt_tpu_torch.convert.weights import load_state  # noqa: E402
from fgt_tpu_torch.models import fgt as fgt_mod  # noqa: E402
from fgt_tpu_torch.ops import corr_fused  # noqa: E402
from fgt_tpu_torch.ops import flash_attention as fa  # noqa: E402
from fgt_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from fgt_tpu_torch.parallel.partition import shard_module  # noqa: E402
from fgt_tpu_torch.utils import checkpoint, dist  # noqa: E402

COUNTERS = (fa.flash_mhsa, fa.flash_attention_dq, fa.flash_attention_dkv)


def dp_share(path: str, mesh) -> list:
    """This rank's dp share of every global batch in ``path`` (keys
    ``{step}/{name}``)."""
    data = np.load(path)
    steps = sorted({int(k.split("/")[0]) for k in data.files})
    out = []
    for s in steps:
        batch = {k.split("/")[1]: data[k] for k in data.files
                 if k.startswith(f"{s}/")}
        b = len(next(iter(batch.values()))) // mesh.dp
        i = mesh.index("dp")
        out.append({k: v[i * b:(i + 1) * b] for k, v in batch.items()})
    return out


def forward(spec: dict, rank: int) -> dict:
    device = torch.device(spec.get("device", "cpu"))
    sp = int(spec["sp"])
    cfg = dict(spec["config"], seq_axis="sp") if sp > 1 else spec["config"]
    model = fgt_mod.Model(cfg)
    load_state(model, checkpoint.load_state_dict(spec["state"]))
    mesh = make_mesh(tp=int(spec["tp"]), sp=sp)
    shard_module(model, mesh)
    model.to(device).eval()
    x = {k: torch.from_numpy(v).to(device)
         for k, v in np.load(spec["inputs"]).items()}
    with torch.no_grad():
        out = model(x["frames"] * (1 - x["masks"]), x["flows"], x["masks"])
    return {"out": out.cpu()}


def gan_step(spec: dict, rank: int) -> dict:
    from fgt_tpu_torch.models import lafc_single
    from fgt_tpu_torch.models.discriminator import TemporalPatchGAN
    from fgt_tpu_torch.parallel.partition import gather_state
    from fgt_tpu_torch.train import schedules
    from fgt_tpu_torch.train.fgt_step import FGTTrainStep

    tp, sp = int(spec["tp"]), int(spec["sp"])
    states = {k: checkpoint.load_state_dict(v)
              for k, v in spec["states"].items()}
    gen = fgt_mod.Model(dict(spec["config"], seq_axis="sp") if sp > 1
                        else spec["config"])
    load_state(gen, states["gen"])
    disc = TemporalPatchGAN(3, int(spec["dist_cnum"]))
    load_state(disc, states["disc"])
    oracle = lafc_single.Model(spec["oracle_config"]).eval()
    load_state(oracle, states["oracle"])
    oracle.requires_grad_(False)
    mesh = make_mesh(tp=tp, sp=sp)
    specs = shard_module(gen, mesh)
    if spec["optimizer"] == "sgd":
        def make_opt(ps):
            return torch.optim.SGD(ps, lr=0.5)
        sched, bi_mode, steps = None, None, 1
    else:
        make_opt = schedules.make_adam
        sched = schedules.warmup_step_decay(2e-3, 2, 0.5, warmup=2)
        bi_mode, steps = "alternate", 3
    step = FGTTrainStep(gen, disc, oracle, make_opt(gen.parameters()),
                        make_opt(disc.parameters()), sched, bi_mode=bi_mode,
                        group=mesh.group("dp"),
                        sp_group=mesh.group("sp") if sp > 1 else None)
    batch = {k: torch.from_numpy(v) for k, v in
             dp_share(spec["batch"], mesh)[0].items()}
    metrics = [{k: float(v) for k, v in step(batch).items()}
               for _ in range(steps)]
    return {"metrics": metrics,
            "gen": gather_state(gen.state_dict(), mesh, specs),
            "disc": disc.state_dict(),
            "own": {k: v.detach().clone() for k, v in
                    gen.state_dict().items()}}


def train(spec: dict, rank: int) -> dict:
    from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer

    device = spec.get("device", "cpu")
    opt = dict(spec["opt"], tp=spec["tp"], sp=spec["sp"])
    if spec.get("kind", "model") == "model":
        trainer = FGTTrainer(opt, device=device)
        own = {"gen": trainer.gen, "disc": trainer.disc}
    else:
        trainer = LAFCTrainer(opt, device=device)
        own = {"model": trainer.model}
    with flash_shapes() as shapes:
        trainer.train(dp_share(spec["batches"], trainer.mesh))
    res = {"flash_shapes": sorted(set(shapes)),
           "own": {k: {n: t.detach().cpu() for n, t in m.state_dict().items()}
                   for k, m in own.items()},
           "param_bytes": {k: sum(p.numel() * p.element_size()
                                  for p in m.parameters())
                           for k, m in own.items()}}
    if spec.get("kind", "model") == "model":
        gen, _ = trainer.full_state()
        res.update(gen={k: v.cpu() for k, v in gen.items()},
                   run_dir=trainer.run_dir)
    return res


def sampler(spec: dict, rank: int) -> dict:
    from fgt_tpu_torch.train.trainer import LAFCTrainer

    opt = dict(spec["opt"], tp=spec["tp"], sp=spec["sp"])
    trainer = LAFCTrainer(opt, device=spec.get("device", "cpu"))
    trainer.sampler.set_epoch(0)
    try:
        batch = next(iter(trainer.train_loader))
    finally:
        trainer.train_loader.close()
    return {"indices": list(trainer.sampler), "batch": batch}


@contextlib.contextmanager
def flash_shapes():
    """Yields a list that gets (kernel entry, N, L) of every launch of
    K2, K4 and K5 inside the block; the launch counts stay the wrappers'
    own."""
    shapes, real_kernel = [], fa._kernel

    def recording_kernel(lib, name, n_ptrs):
        launch = real_kernel(lib, name, n_ptrs)

        def call(*a):
            shapes.append((name, a[n_ptrs], a[n_ptrs + 1]))
            return launch(*a)
        return call

    fa._kernel = recording_kernel
    try:
        yield shapes
    finally:
        fa._kernel = real_kernel


def inference(spec: dict, rank: int) -> dict:
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    args = vi.build_parser().parse_args(spec["argv"])
    args.device = spec.get("device", "cpu")
    device = torch.device(args.device)
    models = vi.build_models(args)
    counters = (corr_fused.lookup_corr_fused, fa.flash_mhsa)
    passes = []
    for _ in range(int(spec.get("passes", 1))):
        for c in counters:
            c.launches = 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        timer = vi.StageTimer(device)
        with flash_shapes() as shapes:
            out = vi.inpaint_from_args(args, models, timer)
        passes.append({
            "stages": dict(timer.times),
            "k2_shapes": [(n, l) for _, n, l in shapes],
            "launches": {c.__name__: c.launches for c in counters},
            "peak": (torch.cuda.max_memory_allocated(device)
                     if device.type == "cuda" else 0)})
    return {"out": out, "passes": passes,
            "fgt_bytes": sum(p.numel() * p.element_size()
                             for p in models.fgt.parameters())}


JOBS = {"forward": forward, "gan_step": gan_step, "train": train,
        "sampler": sampler, "inference": inference}


def run(spec: dict, rank: int) -> None:
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{spec['address']}",
        world_size=int(spec["world"]), rank=rank)
    try:
        for c in COUNTERS:
            c.launches = 0
        cuda = torch.device(spec.get("device", "cpu")).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res = JOBS[spec["job"]](spec, rank)
        res["launches"] = {c.__name__: c.launches for c in COUNTERS}
        res["peak"] = torch.cuda.max_memory_allocated() if cuda else 0
        torch.save(res, os.path.join(spec["out"],
                                     f"{spec['name']}_rank{rank}.pt"))
    finally:
        dist.shutdown()


def main(rank: int, spec_paths: list) -> None:
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    for path in spec_paths:
        with open(path) as f:
            run(json.load(f), rank)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2:])
