"""One rank of a data-parallel training run, for
``tests/test_torch_port_dp.py`` (on the CPU) and ``chip_smoke.py`` (two
ranks on one card):

    python tests/torch_port_dp_worker.py RANK SPEC.json [SPEC.json ...]

runs each SPEC in turn (one process start for several runs). A SPEC holds ``kind`` ("lafc", "lafc_single" or "model"), ``world``,
``address`` (host:port of the rendezvous), ``device`` ("cpu", or
"cuda:0" for every rank), ``opt`` (the trainer's options), ``batches``
(an ``.npz`` of the global batches, keys ``{step}/{name}``) and ``out``.
The rank joins a gloo group (NCCL refuses two ranks on one card), builds
the trainer, which finds the group initialised, trains on its shard of
each global batch (rows ``rank * b`` to ``(rank + 1) * b``) in f32 (TF32
off) and saves its models' state dicts and its flash kernels' launch
counts (over that run) to ``out/{kind}_rank{RANK}.pt``. Imports torch
and the port only.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fgt_tpu_torch.ops import flash_attention as fa  # noqa: E402
from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer  # noqa: E402
from fgt_tpu_torch.utils import dist  # noqa: E402


def shards(path: str, rank: int, world: int) -> list:
    data = np.load(path)
    steps = sorted({int(k.split("/")[0]) for k in data.files})
    out = []
    for s in steps:
        batch = {k.split("/")[1]: data[k] for k in data.files
                 if k.startswith(f"{s}/")}
        b = len(next(iter(batch.values()))) // world
        out.append({k: v[rank * b:(rank + 1) * b] for k, v in batch.items()})
    return out


def run(spec: dict, rank: int) -> None:
    world, device = int(spec["world"]), spec.get("device", "cpu")
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{spec['address']}", world_size=world,
        rank=rank)
    counters = (fa.flash_mhsa, fa.flash_attention_dq, fa.flash_attention_dkv)
    try:
        for c in counters:
            c.launches = 0
        opt = spec["opt"]
        if spec["kind"] == "model":
            trainer = FGTTrainer(opt, device=device)
            models = {"gen": trainer.gen, "disc": trainer.disc}
        else:
            trainer = LAFCTrainer(opt, device=device)
            models = {"model": trainer.model}
        trainer.train(shards(spec["batches"], rank, world))
        torch.save({"models": {k: {n: t.cpu() for n, t in
                                   m.state_dict().items()}
                               for k, m in models.items()},
                    "launches": {c.__name__: c.launches for c in counters}},
                   os.path.join(spec["out"], f"{spec['kind']}_rank{rank}.pt"))
    finally:
        dist.shutdown()


def main(rank: int, spec_paths: list) -> None:
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for path in spec_paths:
        with open(path) as f:
            run(json.load(f), rank)


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2:])
