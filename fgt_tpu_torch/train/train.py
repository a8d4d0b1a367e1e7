"""Training CLI for both stages — counterpart of
``fgt_tpu/train/train.py`` (reference FGT/train.py, LAFC/train.py;
argparse surfaces FGT/inputs.py:4-83, LAFC/flow_inputs.py:4-50):

    python -m fgt_tpu_torch.train.train --model model       --opt cfg.yaml
    python -m fgt_tpu_torch.train.train --model lafc        --opt cfg.yaml
    python -m fgt_tpu_torch.train.train --model lafc_single --opt cfg.yaml

YAML keys override the flags (reference parse.py:28); ``--datadir``
prefixes the relative paths of ``datasets.dataInfo``. Frames are JPEG or
PNG, flows ``.flo`` (``data/datasets.py``). Runs on the card unless
``--device cpu`` is given; there is no fallback to the CPU.

Data parallelism, one process per card (the JAX CLI's flags)::

    python -m fgt_tpu_torch.train.train ... --coordinator HOST:PORT \
        --num_processes N --process_id I

initialises a process group (NCCL on the card, gloo with ``--device
cpu``); process I takes ``cuda:{I % device_count}``. ``torchrun``'s
environment, or a group the caller already made, serves as well
(``utils/dist.py``). ``batch_size`` is per process.

Tensor and sequence parallelism of the FGT generator (``--tp N``,
``--sp N``; ``parallel/``): the ranks form a (dp, tp, sp) grid with dp =
ranks / (tp·sp), e.g. ``torchrun --nproc_per_node 4 -m
fgt_tpu_torch.train.train --model model --opt cfg.yaml --tp 2 --sp 2``.
``batch_size`` is then per dp rank. LAFC and LAFC-single replicate
across tp and sp. A tp·sp that does not divide the ranks raises before
the rendezvous.
"""

from __future__ import annotations

import argparse

from fgt_tpu_torch import DEFAULT_DEVICE
from fgt_tpu_torch.utils.config import (derive_model_tuples, merge_args_yaml,
                                        prefix_paths)


def args_parser(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="fgt_tpu_torch trainer")
    p.add_argument("--opt", type=str, default=None,
                   help="Path to YAML config (overrides argparse defaults)")
    p.add_argument("--model", type=str, default="model",
                   choices=["model", "fgt", "lafc", "lafc_single"])
    p.add_argument("--name", type=str, default="FGT_train")
    p.add_argument("--outputdir", type=str, default="outputs")
    p.add_argument("--datadir", type=str, default="")
    p.add_argument("--datasetName_train", type=str, default=None)
    p.add_argument("--finetune", type=int, default=0)
    p.add_argument("--gen_state", type=str, default="")
    p.add_argument("--dis_state", type=str, default="")
    p.add_argument("--opt_state", type=str, default="")
    p.add_argument("--record_iter", type=int, default=16)
    p.add_argument("--flow_checkPoint", type=str, default="")
    p.add_argument("--dataMode", type=str, default="resize")
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--tp", type=int, default=1,
                   help="Megatron tensor-parallel degree for the FGT "
                        "generator (attention heads / FFN hidden and their "
                        "Adam state split over tp ranks)")
    p.add_argument("--sp", type=int, default=1,
                   help="Ulysses sequence-parallel degree: the FGT folded "
                        "frame axis split over sp ranks (ranks = "
                        "dp*tp*sp)")
    p.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                   help="torch device (default cuda; cpu for the CPU)")

    # data
    p.add_argument("--flow2rgb", type=int, default=1)
    p.add_argument("--flow_direction", type=str, default="for",
                   choices=["for", "back", "bi"])
    p.add_argument("--num_frames", type=int, default=5)
    p.add_argument("--num_flows", type=int, default=3)
    p.add_argument("--flow_interval", type=int, default=3)
    p.add_argument("--sample", type=str, default="random",
                   choices=["random", "seq"])
    p.add_argument("--max_val", type=float, default=0.01)
    p.add_argument("--norm", type=int, default=0)

    # model
    p.add_argument("--res_h", type=int, default=240)
    p.add_argument("--res_w", type=int, default=432)
    p.add_argument("--in_channel", type=int, default=4)
    p.add_argument("--cnum", type=int, default=64)
    p.add_argument("--flow_inChannel", type=int, default=2)
    p.add_argument("--flow_cnum", type=int, default=64)
    p.add_argument("--dist_cnum", type=int, default=32)
    p.add_argument("--frame_hidden", type=int, default=512)
    p.add_argument("--flow_hidden", type=int, default=256)
    p.add_argument("--PASSMASK", type=int, default=1)
    p.add_argument("--numBlocks", type=int, default=8)
    p.add_argument("--kernel_size_w", type=int, default=7)
    p.add_argument("--kernel_size_h", type=int, default=7)
    p.add_argument("--stride_h", type=int, default=3)
    p.add_argument("--stride_w", type=int, default=3)
    p.add_argument("--pad_h", type=int, default=3)
    p.add_argument("--pad_w", type=int, default=3)
    p.add_argument("--num_head", type=int, default=4)
    p.add_argument("--conv_type", type=str, default="vanilla",
                   choices=["vanilla", "gated", "partial"])
    p.add_argument("--use_bias", type=int, default=1)
    p.add_argument("--ape", type=int, default=1)
    p.add_argument("--mlp_ratio", type=int, default=40)
    p.add_argument("--drop", type=float, default=0)
    p.add_argument("--init_weights", type=int, default=1)
    p.add_argument("--use_residual", type=int, default=1)
    p.add_argument("--resBlocks", type=int, default=1)
    p.add_argument("--use_edges", type=int, default=0)
    p.add_argument("--gc", type=int, default=0)

    # losses
    p.add_argument("--L1M", type=float, default=1)
    p.add_argument("--L1V", type=float, default=1)
    p.add_argument("--adv", type=float, default=0.01)

    # windows
    p.add_argument("--tw", type=int, default=2)
    p.add_argument("--sw", type=int, default=8)
    p.add_argument("--gd", type=int, default=4)
    p.add_argument("--ref_length", type=int, default=10)
    p.add_argument("--use_valid", action="store_true")

    # data parallelism (the JAX CLI's multi-host flags)
    p.add_argument("--coordinator", type=str, default="")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    return p.parse_args(argv)


def build_opt(args: argparse.Namespace) -> dict:
    """The flags, overridden by the YAML, with the derived tuples and the
    training defaults (``fgt_tpu/train/train.py:build_opt``)."""
    opt = merge_args_yaml(args, args.opt)
    opt = derive_model_tuples(opt)
    opt.setdefault("model", args.model)
    opt.setdefault("train", {})
    opt["train"].setdefault("MAX_ITERS", 500000)
    opt["train"].setdefault("lr", 1e-4)
    opt["train"].setdefault("UPDATE_INTERVAL", 300000)
    opt.setdefault("datasets", {})
    if args.datadir and "dataInfo" in opt.get("datasets", {}):
        opt["datasets"]["dataInfo"] = prefix_paths(
            opt["datasets"]["dataInfo"], args.datadir)
    opt.setdefault("path", {})
    for k in ("gen_state", "dis_state", "opt_state"):
        v = getattr(args, k, "")
        if v:
            opt["path"][k] = v
    opt["resume"] = bool(opt["path"].get("gen_state"))
    return opt


def main(argv=None):
    args = args_parser(argv)
    opt = build_opt(args)

    from fgt_tpu_torch.utils import dist

    ranks = dist.ranks_from_flags(str(opt.get("coordinator") or ""),
                                  int(opt.get("num_processes") or 0))
    tp, sp = int(opt.get("tp", 1) or 1), int(opt.get("sp", 1) or 1)
    if ranks % (tp * sp):
        raise ValueError(f"--tp {tp} x --sp {sp} does not divide the "
                         f"{ranks} ranks")
    had_group = dist.initialized()
    device = dist.init_from_flags(
        str(opt.get("coordinator") or ""), int(opt.get("num_processes") or 0),
        int(opt.get("process_id", -1)), str(opt.get("device", args.device)))
    try:
        trainer = _build_trainer(opt, args, device)
        trainer.train()
    finally:
        if not had_group:
            dist.shutdown()
    return trainer


def _build_trainer(opt: dict, args: argparse.Namespace, device: str):
    from fgt_tpu_torch.train.trainer import FGTTrainer, LAFCTrainer

    model = str(opt.get("model", args.model))
    if model in ("model", "fgt"):
        trainer = FGTTrainer(opt, device=device)
    elif model == "lafc":
        trainer = LAFCTrainer(opt, device=device)
    elif model == "lafc_single":
        trainer = LAFCTrainer(opt, device=device, single=True)
    else:
        raise ValueError(f"unknown model {model}")
    return trainer


if __name__ == "__main__":
    main()
