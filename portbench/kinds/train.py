"""GAN training cells: a closed loop of ``FGTTrainStep`` calls (the
port's ``fgt_tpu_torch/train/fgt_step.py``) on batches made on the card
(``portbench/generators/train_batches.py``), the loader bypassed.

Set-up builds one step object (generator, T-PatchGAN, frozen LAFC-single
oracle, the port's Adam and schedule, bf16 mixed precision) on weights
made from the seed, and drives it through its first ``check_steps``
steps by the window's own call and feed. Those steps are the cold ones
and the reference's material: each step's losses, the oracle's flows and
the generator's output of the first, the first gradient of every leaf
(from Adam's first moment after one step) and every leaf's change after
the last. The window then steps the same object until ``seconds`` have
passed and synchronizes once; ``train_steps_per_s`` is every step over
the window's seconds.

The check, once the window has closed, the peak read and the program
freed: the plain reference (f32, TF32 off) takes the same weights and
batches through the same steps. The traced run times the calls the
configuration's ``op_ranges`` name.
"""

from __future__ import annotations

import json
import time

import numpy as np

from portbench import common, counts, traffic, weights
from portbench.kinds.infer import f32_exact, judge, rel_err


def make_states(cfg: dict, seed: int, device) -> dict:
    import torch

    from portbench.reference.fgt import FGT
    from portbench.reference.lafc import LAFCSingle
    from portbench.reference.train import TemporalPatchGAN

    g = torch.Generator(torch.device(device)).manual_seed(seed)
    with torch.device("meta"):
        gen, disc = FGT(cfg["generator"]), TemporalPatchGAN(
            3, cfg["dist_cnum"])
        oracle = LAFCSingle(cfg["flow_config"])
    return {"gen": weights.make_state(gen, weights.normal(0.02), g),
            "disc": weights.make_state(disc, weights.he("in"), g),
            "oracle": weights.make_state(oracle, weights.he("in"), g)}


def program_step(cfg: dict, states: dict, device):
    """The port's step object on ``states``."""
    import torch

    from fgt_tpu_torch.convert.weights import load_state
    from fgt_tpu_torch.models import discriminator, lafc_single
    from fgt_tpu_torch.models import fgt as fgt_mod
    from fgt_tpu_torch.train.fgt_step import FGTLossWeights, FGTTrainStep
    from fgt_tpu_torch.train.schedules import make_adam, warmup_step_decay

    tr = cfg["train"]
    with torch.device(device):
        gen = fgt_mod.Model(cfg["generator"])
        disc = discriminator.TemporalPatchGAN(3, cfg["dist_cnum"])
        oracle = lafc_single.Model(cfg["flow_config"])
    load_state(gen, states["gen"])
    load_state(disc, states["disc"])
    load_state(oracle, states["oracle"])
    oracle.eval().requires_grad_(False)
    betas = tr["BETA1"], tr["BETA2"]
    sched = warmup_step_decay(tr["lr"], decay_interval=tr["UPDATE_INTERVAL"],
                              gamma=tr["lr_decay"], warmup=tr["WARMUP"])
    return FGTTrainStep(
        gen, disc, oracle, make_adam(gen.parameters(), *betas),
        make_adam(disc.parameters(), *betas), sched,
        FGTLossWeights(L1M=tr["L1M"], L1V=tr["L1V"], adv=tr["adv"]),
        mixed_precision=cfg["precision"] == "bf16")


def _leaves(step) -> dict:
    return {**{f"gen.{k}": p for k, p in step.gen.named_parameters()},
            **{f"disc.{k}": p for k, p in step.disc.named_parameters()}}


def _first_grads(step, beta1: float) -> dict:
    """Each leaf's first gradient norm, from Adam's first moment after
    one step (m1 = (1 - beta1) g); 0 where Adam holds no state."""
    out = {}
    for name, p in _leaves(step).items():
        opt = step.g_opt if name.startswith("gen.") else step.d_opt
        m = opt.state.get(p, {}).get("exp_avg")
        out[name] = 0.0 if m is None else float(m.double().norm()) / (
            1 - beta1)
    return out


def record_steps(step, batches, n: int, beta1: float) -> dict:
    """Drive ``step`` through its first ``n`` steps on ``batches``;
    return what the reference follows: the batches, each step's losses,
    the first step's oracle flows and generator output, the first
    gradients and every leaf's change over the ``n`` steps."""
    import torch

    start = {k: p.detach().clone() for k, p in _leaves(step).items()}
    seen = {}

    def keep(key, pick):
        def hook(module, inputs, output):
            seen.setdefault(key, pick(output).detach().float().clone())
        return hook
    hooks = [step.flow_model.register_forward_hook(
                 keep("oracle_flows",
                      lambda o: o[0] if isinstance(o, tuple) else o)),
             step.gen.register_forward_hook(keep("gen_out", lambda o: o))]
    fed, losses = [], []
    for i in range(n):
        batch = batches.next()
        fed.append({k: v.clone() for k, v in batch.items()})
        got = step(batch)
        losses.append({k: float(got[k]) for k in ("gen_loss", "dis_loss")})
        if i == 0:
            for h in hooks:
                h.remove()
            grads = _first_grads(step, beta1)
    moved = {k: float((p.detach() - start[k]).double().norm())
             for k, p in _leaves(step).items()}
    b, t, h, w, c = fed[0]["flows"].shape
    return {"batches": fed, "losses": losses, "grads": grads,
            "moved": moved, "start": start,
            "oracle_flows": seen["oracle_flows"].reshape(-1, t, h, w, c),
            "gen_out": seen["gen_out"]}


def reference_steps(cfg: dict, states: dict, rec: dict, device) -> dict:
    """The reference's readings of the same steps from the same start."""
    import torch

    from portbench.reference.fgt import FGT
    from portbench.reference.lafc import LAFCSingle
    from portbench.reference.train import RefTrainStep, TemporalPatchGAN

    tr = cfg["train"]
    with torch.device(device):
        gen, disc = FGT(cfg["generator"]), TemporalPatchGAN(
            3, cfg["dist_cnum"])
        oracle = LAFCSingle(cfg["flow_config"])
    for m, key in ((gen, "gen"), (disc, "disc"), (oracle, "oracle")):
        m.load_state_dict({k: v.float() for k, v in states[key].items()})
    oracle.eval().requires_grad_(False)
    step = RefTrainStep(gen, disc, oracle, tr["lr"],
                        (tr["BETA1"], tr["BETA2"]), tr["adv"], tr["L1M"],
                        tr["L1V"])
    leaves = {**{f"gen.{k}": p for k, p in gen.named_parameters()},
              **{f"disc.{k}": p for k, p in disc.named_parameters()}}
    start = {k: p.detach().clone() for k, p in leaves.items()}
    losses = []
    for i, batch in enumerate(rec["batches"]):
        got = step(batch)
        losses.append({k: float(got[k]) for k in ("gen_loss", "dis_loss")})
        if i == 0:
            first = got
            grads = {k: float(p.grad.double().norm())
                     for k, p in leaves.items()}
    moved = {k: float((p.detach() - start[k]).double().norm())
             for k, p in leaves.items()}
    return {"losses": losses, "grads": grads, "moved": moved,
            "oracle_flows": first["oracle_flows"],
            "gen_out": first["gen_out"]}


def leaf_gap(prog: dict, ref: dict, keep, label: str = "") -> float:
    """The worst leaf's gap between the two norms, over the reference's
    norm of that leaf."""
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], 1e-30) for k in keep}
    worst = max(gaps, key=gaps.get)
    common.log(f"{label} worst leaf {worst}: {gaps[worst]:.4g} "
               f"(program {prog[worst]:.4g}, reference {ref[worst]:.4g})")
    return gaps[worst]


def compare(rec: dict, ref: dict):
    """The numbers compared, and the ones read but not compared
    (``detail``: no fault or control separates them from sound runs).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone under Adam and are left out."""
    med = float(np.median(list(ref["grads"].values())))
    keep = [k for k, g in ref["grads"].items() if g >= 1e-3 * med]
    loss = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
               for p, r in zip(rec["losses"], ref["losses"])
               for k in ("gen_loss", "dis_loss"))
    checks = {"loss_err": loss,
              "update_err": leaf_gap(rec["moved"], ref["moved"], keep,
                                     "update"),
              "gen_out_err": _rows_err(rec["gen_out"], ref["gen_out"])}
    moved = [ref["moved"][k] for k in keep]
    scale = max(float(np.median(moved)), 1e-30)
    own = [abs(rec["moved"][k] - r) / max(r, 1e-30)
           for k, r in zip(keep, moved)]
    detail = {"grad_err": leaf_gap(rec["grads"], ref["grads"], keep, "grad"),
              "oracle_err": _rows_err(rec["oracle_flows"],
                                      ref["oracle_flows"]),
              "update_median_leaf": float(np.median(own)),
              "update_over_median": max(
                  abs(rec["moved"][k] - r) / max(r, scale)
                  for k, r in zip(keep, moved)),
              "leaves_kept": len(keep), "leaves": len(ref["grads"])}
    common.log("detail " + json.dumps(detail))
    return checks, detail


def _rows_err(got, want) -> float:
    """rel_err over the rows both hold (a step fed fewer rows than the
    batch has is caught by the other numbers)."""
    n = min(got.shape[0], want.shape[0])
    return rel_err(got[:n].cpu().numpy(), want[:n].cpu().numpy())


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float) -> dict:
    """One run of the cell (see :func:`portbench.kinds.infer.run`)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    common.log(f"imported {time.perf_counter() - t_start:.2f} s")
    states = make_states(cfg, seed, device)
    step = program_step(cfg, states, device)
    common.log(f"step built {time.perf_counter() - t_start:.2f} s")
    batches = traffic.make(mix, seed + 1, device)
    common.log(f"traffic {time.perf_counter() - t_start:.2f} s")
    rec = record_steps(step, batches, cfg["check_steps"],
                       cfg["train"]["BETA1"])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    common.log(f"set-up {setup_s:.2f} s")

    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step(batches.next())
        n += 1
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"kind": "train", "items": n, "window_s": window_s,
           "setup_s": setup_s, "peak_bytes": peak}
    common.log(f"window {window_s:.2f} s, {ctx['items']} items")
    if trace:
        t_trace = time.perf_counter()
        ctx.update(traced(step, batches, cfg, mix))
        common.log(f"traced {time.perf_counter() - t_trace:.2f} s")
    del step, batches
    rec.pop("start")
    if cuda:
        torch.cuda.empty_cache()
        f32_exact()
    t_check = time.perf_counter()
    checks, _ = compare(rec, reference_steps(cfg, states, rec, device))
    common.log(f"check {time.perf_counter() - t_check:.2f} s")
    return {"ctx": ctx, "attempted": n, "failed": 0,
            "checks": judge(checks, cell["limits"])}


def traced(step, batches, cfg: dict, mix: dict) -> dict:
    """Step FLOPs, then ``profile_steps`` profiled steps for the
    rooflines, the idle share and the breakdown."""
    ranges = cfg["op_ranges"]
    flops = counts.train_step_flops(cfg["generator"], cfg["flow_config"],
                                    cfg["dist_cnum"], mix["batch"],
                                    mix["frames"], mix["height"],
                                    mix["width"])
    with common.OpRanges(common.op_targets(ranges)) as rec:
        prof = common.profile(lambda: [step(batches.next()) for _ in
                                       range(cfg["profile_steps"])])
    return {"flops_per_item": flops, "trace": common.read_trace(prof),
            "bound_s": common.op_bounds(ranges, rec.calls)}
