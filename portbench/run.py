"""The benchmark of ``fgt_tpu_torch`` on NVIDIA GPUs: one run of one
cell.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's file ``portbench/workloads/<name>.json`` names its
configuration (``portbench/configs/``), its traffic mix
(``portbench/traffic/``) and the limits of its check; the
configuration's ``kind`` names the module that runs it
(``portbench/kinds/<kind>.py``); ``BENCHMARK.json``
at the checkout's root names the metrics the cell reports, each read by
``portbench/metrics/<metric>.py``. ``--trace 0`` reports the end-to-end
metrics, ``--trace 1`` the per-layer ones. The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
compared numbers beside their limits under ``checks``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import common  # noqa: E402

ROOT = os.path.dirname(common.HERE)


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metrics ``BENCHMARK.json`` gives cell ``name``: end-to-end
    ones whose ``workloads`` list it (or that have none); with ``trace``
    the per-layer ones that list it, or that have no list and move an
    end-to-end metric the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e
                             else [])]


def load_cell(name: str):
    cell = common.load_json("workloads", f"{name}.json")
    cfg = common.load_json("configs", f"{cell['config']}.json")
    from portbench.traffic import load_mix
    return cell, cfg, load_mix(cell["traffic"])


def run_cell(name: str, cell: dict, cfg: dict, mix: dict, metrics: list,
             seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run, on any device (the tests drive it on the CPU at small
    sizes): the result line's fields but ``device``."""
    import importlib

    kind = importlib.import_module(f"portbench.kinds.{cfg['kind']}")
    out = kind.run(cell, cfg, mix, seed, seconds, trace, device, t_start)
    checks = out["checks"]
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": common.read_metrics(metrics, out["ctx"])}
    if trace:
        result["breakdown"] = out["ctx"]["trace"]["breakdown"]
    result["ctx"] = out["ctx"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    common.log(f"torch imported {time.perf_counter() - T_START:.2f} s")
    if not torch.cuda.is_available():
        common.log("no CUDA device: the benchmark measures the card only")
        return 2
    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    cell, cfg, mix = load_cell(args.workload)
    want = next(w for w in bench["workloads"] if w["name"] == args.workload)
    if torch.cuda.device_count() < want["chips"]:
        common.log(f"{want['chips']} cards wanted, "
                   f"{torch.cuda.device_count()} found")
        return 2
    common.log(f"card: {common.power_limit()} at "
               f"{time.perf_counter() - T_START:.2f} s; peaks: "
               f"{common.PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
               f"{common.PEAK_BYTES_PER_S / 1e12:.2f} TB/s")
    metrics = cell_metrics(bench, args.workload, bool(args.trace))
    result = run_cell(args.workload, cell, cfg, mix, metrics, args.seed,
                      args.seconds, bool(args.trace), "cuda", T_START)
    ctx = result.pop("ctx")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": want["chips"],
              "memory_peak_bytes": int(ctx["peak_bytes"])}
    if args.trace:
        device.update(busy_s=ctx["trace"]["busy_s"],
                      window_s=ctx["trace"]["window_s"])
    checks = result.pop("checks")
    result["device"] = device
    result["checks"] = checks
    found = common.forbidden_modules()
    if found:
        common.log(f"JAX or the JAX package was loaded: {found}")
        return 3
    common.log("checks: " + common.checks_line(checks))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
