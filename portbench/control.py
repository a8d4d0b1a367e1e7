"""Readings the limits of a cell's check are set from (the benchmark's
own runs never run this):

    python -m portbench.control --workload <name> --side <side> \
        --seeds <n> [<n> ...] [--out readings.jsonl]

Each seed makes the cell's weights and traffic as a run does and prints
one JSON line of the numbers the cell compares:

* ``program``: the port on the clip a run would check (after one cold
  clip), or its first ``check_steps`` training steps: the lower readings;
* ``control``: the plain reference computed in fp8
  (:mod:`portbench.reference.lowp`) in the program's place: the upper
  readings;
* ``half_batch`` (training cells): the port stepping on half of each
  batch, the mean taken over the rest;
* ``frozen_small`` (training cells): the port with every leaf of one
  dimension (biases, norm scales) left unchanged by each step;
* ``no_propagation`` (removal cells): the port with s4's flowNN filling
  nothing, so FGT fills what propagation would have.

A state left unchanged reads 1 by the training comparison's measure and
needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from portbench import common, traffic
from portbench.kinds import infer
from portbench.kinds import train as train_cell


def removal_program(cfg, states, clip, device) -> dict:
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    kw = cfg["inpaint"]
    models = infer.program_models(cfg, states, device)
    vi.inpaint(*clip, models, timer=common.StageClock(device), **kw)
    out = vi.inpaint(*clip, models, timer=common.StageClock(device), **kw)
    prog = infer.program_flows(vi, models, *clip, kw)
    prog["frames"] = out
    return prog


def no_propagation(vi):
    """Plant the fault in the program's module ``vi``: s4's flowNN
    returns its gradients and fills no pixel. Returns the undo."""
    saved = vi.get_flownn_gradient_frames

    def fill_nothing(pcfg, gx, gy, mask, *a, **k):
        return gx, gy, np.zeros(np.shape(mask), bool)
    vi.get_flownn_gradient_frames = fill_nothing
    return lambda: setattr(vi, "get_flownn_gradient_frames", saved)


def removal_no_propagation(cfg, states, clip, device) -> dict:
    from fgt_tpu_torch.pipeline import video_inpainting as vi

    undo = no_propagation(vi)
    try:
        return removal_program(cfg, states, clip, device)
    finally:
        undo()


def removal_control(cfg, states, clip, device) -> dict:
    """The fp8 reference run end to end on the clip, in the program's
    place."""
    from portbench.reference import pipeline as rp
    from portbench.reference.lowp import fp8_products

    frames, masks = clip
    kw = cfg["inpaint"]
    ref = infer.reference_models(cfg, states, device)
    with fp8_products():
        ff, fb = rp.s1_flows(ref, frames.astype(np.float32))
        cf, cb = rp.s2_flows(ref, ff, fb, masks, kw["flow_mask_dilates"])
        out, _ = rp.s3_s6(ref, frames.astype(np.float32), masks, cf, cb,
                          kw["frame_dilates"])
    return {"s1": [ff.cpu().numpy(), fb.cpu().numpy()],
            "s2": [cf.cpu().numpy(), cb.cpu().numpy()], "frames": out}


def removal_reading(cfg, mix, seed, side, device) -> dict:
    import torch

    states = infer.make_states(cfg, cfg["weight_seed"], device)
    clips = traffic.make(mix, seed, device)
    clip = clips[int(np.random.RandomState(seed % 2 ** 32)
                     .randint(len(clips)))]
    infer.f32_exact()
    side_fn = {"program": removal_program, "control": removal_control,
               "no_propagation": removal_no_propagation}[side]
    got = side_fn(cfg, states, clip, device)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    checks, detail = infer.compare(infer.reference_models(cfg, states, device),
                                   *clip, got, cfg["inpaint"])
    return {**checks, "detail": detail}


class HalfBatch:
    """The step fed the first half of each batch's rows."""

    def __init__(self, step):
        self.step = step

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, batch):
        half = batch["frames"].shape[0] // 2
        return self.step({k: v[:half] for k, v in batch.items()})


def frozen_small_call(step, call, batch):
    """``call(batch)``, then every one-dimensional leaf of ``step``'s
    generator and discriminator (biases, norm scales) put back, as a
    step that never updates them."""
    import torch

    small = [p for m in (step.gen, step.disc) for p in m.parameters()
             if p.dim() == 1]
    saved = [p.detach().clone() for p in small]
    got = call(batch)
    with torch.no_grad():
        for p, s in zip(small, saved):
            p.copy_(s)
    return got


class FrozenSmall:
    """The step under :func:`frozen_small_call`."""

    def __init__(self, step):
        self.step = step

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, batch):
        return frozen_small_call(self.step, self.step, batch)


class ControlStep:
    """The reference step in fp8 in the program's place, with the
    attributes ``record_steps`` reads."""

    def __init__(self, cfg, states, device):
        from portbench.reference.fgt import FGT
        from portbench.reference.lafc import LAFCSingle
        from portbench.reference.train import RefTrainStep, TemporalPatchGAN
        import torch

        tr = cfg["train"]
        with torch.device(device):
            gen = FGT(cfg["generator"])
            disc = TemporalPatchGAN(3, cfg["dist_cnum"])
            oracle = LAFCSingle(cfg["flow_config"])
        for m, key in ((gen, "gen"), (disc, "disc"), (oracle, "oracle")):
            m.load_state_dict({k: v.float() for k, v in states[key].items()})
        oracle.eval().requires_grad_(False)
        self.ref = RefTrainStep(gen, disc, oracle, tr["lr"],
                                (tr["BETA1"], tr["BETA2"]), tr["adv"],
                                tr["L1M"], tr["L1V"])
        self.gen, self.disc, self.flow_model = gen, disc, oracle
        self.g_opt, self.d_opt = self.ref.g_opt, self.ref.d_opt

    def __call__(self, batch):
        from portbench.reference.lowp import fp8_products

        with fp8_products():
            got = self.ref(batch)
        return got


def train_reading(cfg, mix, seed, side, device) -> dict:
    import torch

    states = train_cell.make_states(cfg, seed, device)
    if side == "control":
        step = ControlStep(cfg, states, device)
    else:
        step = train_cell.program_step(cfg, states, device)
        if side == "half_batch":
            step = HalfBatch(step)
        elif side == "frozen_small":
            step = FrozenSmall(step)
    batches = traffic.make(mix, seed + 1, device)
    rec = train_cell.record_steps(step, batches, cfg["check_steps"],
                                  cfg["train"]["BETA1"])
    rec.pop("start")
    del step
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    infer.f32_exact()
    checks, detail = train_cell.compare(rec, train_cell.reference_steps(
        cfg, states, rec, device))
    return {**checks, "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", required=True,
                   choices=("program", "control", "half_batch",
                            "frozen_small", "no_propagation"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from portbench.run import load_cell

    _, cfg, mix = load_cell(args.workload)
    read = removal_reading if cfg["kind"] == "infer" else train_reading
    for seed in args.seeds:
        line = json.dumps({"workload": args.workload, "side": args.side,
                           "seed": seed,
                           **read(cfg, mix, seed, args.side, "cuda")})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
