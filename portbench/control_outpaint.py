"""Readings the limits of a video-extrapolation cell's check are set
from (the benchmark's own runs never run this):

    python -m portbench.control_outpaint --workload <name> --side <side> \
        --seeds <n> [<n> ...] [--out readings.jsonl]

Each seed makes the cell's weights and traffic as a run does and prints
one JSON line of the numbers the cell compares
(:func:`portbench.kinds.outpaint.compare`) on the clip a run would
check:

* ``program``: the port (after one cold clip): the lower readings;
* ``control``: the plain reference computed in fp8
  (:mod:`portbench.reference.lowp`) in the program's place, end to end:
  the upper readings;
* ``no_propagation``: the port with s4's flowNN filling nothing
  (:func:`portbench.control.no_propagation`), so FGT fills what
  propagation would have.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from portbench import control, traffic
from portbench.kinds import infer, outpaint


def fp8_control(cfg, states, clip, device) -> dict:
    """The fp8 reference run end to end on the clip, in the program's
    place."""
    from portbench.reference import extrapolation as rx
    from portbench.reference import pipeline as rp
    from portbench.reference.lowp import fp8_products

    frames, _ = clip
    kw = cfg["inpaint"]
    ref = infer.reference_models(cfg, states, device)
    with fp8_products():
        ff, fb = rp.s1_flows(ref, frames.astype(np.float32))
        canvas, pf, pb, border, _ = rx.extrapolation(
            frames.astype(np.float32), ff, fb, kw["h_scale"], kw["w_scale"])
        holes = np.repeat(border[None], frames.shape[0], 0)
        cf, cb = rp.s2_flows(ref, pf, pb, holes, 0)
        out, _ = rx.s3_s6(ref, canvas, holes, cf, cb)
    return {"s1": [ff.cpu().numpy(), fb.cpu().numpy()],
            "s2": [cf.cpu().numpy(), cb.cpu().numpy()], "frames": out}


def reading(cfg, mix, seed, side, device) -> dict:
    import torch

    states = infer.make_states(cfg, cfg["weight_seed"], device)
    clips = traffic.make(mix, seed, device)
    clip = clips[int(np.random.RandomState(seed % 2 ** 32)
                     .randint(len(clips)))]
    infer.f32_exact()
    side_fn = {"program": control.removal_program, "control": fp8_control,
               "no_propagation": control.removal_no_propagation}[side]
    got = side_fn(cfg, states, clip, device)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    checks, detail = outpaint.compare(
        infer.reference_models(cfg, states, device), clip[0], got,
        cfg["inpaint"])
    return {**checks, "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", required=True,
                   choices=("program", "control", "no_propagation"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from portbench.run import load_cell

    _, cfg, mix = load_cell(args.workload)
    for seed in args.seeds:
        line = json.dumps({"workload": args.workload, "side": args.side,
                           "seed": seed,
                           **reading(cfg, mix, seed, args.side, "cuda")})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
