"""What every cell shares: the published peaks, logging, the stage
clock handed to the program, the profiler's reading (device busy time as
the union of kernel intervals, time at an op's call boundary, the
breakdown), the per-layer metric readers, and the result line."""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

FORBIDDEN = ("jax", "jaxlib", "flax", "fgt_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "not read"


class StageClock:
    """The ``stage(name)`` object the program's ``inpaint(timer=...)``
    takes: seconds a stage, synchronized at both edges so device work is
    charged to the stage that queued it. With ``annotate`` each stage is
    also a ``record_function`` range named ``pb.stage.<name>``."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.times: dict = {}
        self.annotate = False

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        rng = (self.torch.profiler.record_function(f"pb.stage.{name}")
               if self.annotate else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with rng:
                yield
                self._sync()
        finally:
            self.times[name] = self.times.get(name, 0.0) + \
                time.perf_counter() - t0


class OpRanges:
    """Wraps functions of the program's modules, for the traced stretch
    only, in ``record_function`` ranges named ``pb.<label>`` and records
    each call's arguments, so an op's device time is read at its call
    boundary whatever kernel serves it."""

    def __init__(self, targets: dict):
        self.targets = targets          # label -> (module, attribute)
        self.calls: dict = {k: [] for k in targets}
        self._saved = []

    def __enter__(self):
        import torch

        for label, (mod, attr) in self.targets.items():
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            @functools.wraps(fn)    # keeps the program's launch counters
            def wrapped(*a, _fn=fn, _label=label, **kw):
                self.calls[_label].append((a, kw))
                with torch.profiler.record_function(f"pb.{_label}"):
                    return _fn(*a, **kw)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


def profile(fn):
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities)
    inside a ``pb.window`` range; returns the profiler."""
    import torch
    from torch.profiler import ProfilerActivity

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        with torch.profiler.record_function("pb.window"):
            fn()
            sync()
    return prof


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(prof) -> dict:
    """From a profiler's raw events: the traced window's seconds, the
    device's busy seconds (the union of kernel, copy and set intervals,
    so overlapping kernels count once), the device seconds of the
    kernels inside each ``pb.<label>`` range (those lying within the
    range's span on the device's timeline), and the breakdown (the
    device operations that took most time; the longest idle gaps, each
    named by the stage range it fell in)."""
    from torch.autograd import DeviceType

    cpu, notes, dev = [], [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
        if e.device_type() == DeviceType.CPU:
            if span[2].startswith("pb."):
                cpu.append(span)
        elif e.is_user_annotation() or span[2].startswith("pb."):
            notes.append(span)
        else:
            dev.append(span)
    win = [s for s in cpu if s[2] == "pb.window"]
    if not win:
        raise RuntimeError("the profiler recorded no pb.window range")
    w0, w1 = win[0][:2]
    dev.sort()
    busy = _merge([(max(s, w0), min(e, w1)) for s, e, _ in dev
                   if min(e, w1) > max(s, w0)])
    by_name: dict = {}
    for s, e, n in dev:
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    stages = [(s, e, n[len("pb.stage."):]) for s, e, n in cpu
              if n.startswith("pb.stage.")]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            mid = (s + e) / 2
            label = next((n for a, b, n in stages if a <= mid <= b),
                         "between stages")
            gaps.append((label, (e - s) / 1e6))
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    starts = [s for s, _, _ in dev]
    ranges: dict = {}
    for a0, a1, name in notes:
        if not name.startswith("pb.") or name.startswith(
                ("pb.stage.", "pb.window")):
            continue
        i = bisect.bisect_left(starts, a0)
        inside = 0.0
        while i < len(dev) and dev[i][0] <= a1:
            if dev[i][1] <= a1:
                inside += dev[i][1] - dev[i][0]
            i += 1
        ranges[name[3:]] = ranges.get(name[3:], 0.0) + inside / 1e6
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(e - s for s, e in busy) / 1e6, "range_s": ranges,
            "breakdown": {"device_ops": [[n, d / 1e6] for n, d in ops],
                          "idle_gaps": [[n, s] for n, s in gaps]}}


def load_module(folder: str, name: str):
    """``portbench/<folder>/<name>.py``, loaded from its file: a metric's
    reader, a traffic generator, a hole shape, a kernel's count rule."""
    path = os.path.join(HERE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    return load_module("metrics", name).read


def op_targets(ranges: dict) -> dict:
    """label -> (module, attribute) of each range's call, for
    :class:`OpRanges`. ``ranges`` is a configuration's ``op_ranges``:
    label -> {"call": "<module>:<function>", "rule": <count rule>}."""
    out = {}
    for label, r in ranges.items():
        mod, attr = r["call"].split(":")
        out[label] = (importlib.import_module(mod), attr)
    return out


def op_bounds(ranges: dict, calls: dict) -> dict:
    """label -> the least seconds of the recorded calls, by the range's
    count rule ``portbench/rules/<rule>.py``."""
    out = {}
    for label, r in ranges.items():
        rule = load_module("rules", r["rule"]).bound_s
        out[label] = sum(rule(*a, **kw) for a, kw in calls[label])
    return out


def read_metrics(names, ctx: dict) -> dict:
    """Each named per-layer metric that finds something to read."""
    out = {}
    for name in names:
        got = metric_reader(name)(ctx)
        if got is not None:
            value, unit = got
            out[name] = {"value": float(value), "unit": unit}
    return out


def checks_line(checks: dict) -> str:
    """The compared numbers, each beside its limit, for standard error."""
    return "; ".join(f"{k} {v['value']!r} limit {v['limit']!r}"
                     for k, v in checks.items())


def roofline_share(ctx: dict, labels, kind: str):
    """The bound seconds of the calls of ``labels`` over the device
    seconds inside their call boundaries, in %, or None where the run
    traced none of them."""
    if ctx["kind"] != kind or "trace" not in ctx:
        return None
    device = sum(ctx["trace"]["range_s"].get(k, 0.0) for k in labels)
    if device <= 0:
        return None
    return 100.0 * sum(ctx["bound_s"][k] for k in labels) / device, "%"
