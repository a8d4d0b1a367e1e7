"""On-demand ``torch.profiler`` traces, and the program's spans and
counters — the port's counterpart of ``fgt_tpu/utils/profiling.py``.

    with maybe_trace("/tmp/fgt_trace", torch.device("cuda")):
        ... run stages ...

writes ``/tmp/fgt_trace/trace.json`` (Chrome trace format: Perfetto or
chrome://tracing) and ``/tmp/fgt_trace/spans.jsonl`` (one line per span
recorded inside the block). Unlike the JAX package's, a trace that
cannot be taken raises: a run asked to profile does not go on
unprofiled.

Spans and counters (:func:`span`, :func:`count`) mark the program's
stages and phases. They record only while a ``torch.profiler`` session
is recording or after ``enable_spans(True)``; otherwise :func:`span`
checks that and returns a shared no-op context, and :func:`count` finds
no open span. A recorded span keeps, in memory (the last
:data:`MAX_SPANS`, :func:`spans`):

* ``name``, ``id``, ``parent`` (the enclosing span's id, None for a
  root) and ``root`` (the root's id: one clip or one training step);
* ``start_ns`` and ``end_ns``: host times in the profiler's own time
  base (the epoch nanoseconds of its events' ``start_ns()``), converted
  from ``time.perf_counter_ns`` by an anchor pair taken as each root
  opens (:func:`_anchor`); the start is read before the span's
  ``record_function`` range opens, since the first range a process
  opens under a profiler returns a millisecond or more after the
  profiler stamps its start;
* ``device_ms``: on a CUDA device (a root's ``device``, inherited by its
  children) the interval between two timing events recorded on the
  current stream at the span's edges, busy or waiting; resolved when the
  records are read, None elsewhere;
* ``counters`` (added by :func:`count`) and ``attrs`` (the span's
  keyword arguments).

Under a profiler each span is also a ``record_function`` range of the
same name, so it sits in the trace beside the kernels it launched. The
spans of one process nest as one stack: open them from one thread.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

logger = logging.getLogger("fgt_tpu_torch")

MAX_SPANS = 100_000

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Recorder:
    """The process's span records and its open spans."""

    def __init__(self):
        self.forced = False
        self.records: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.dropped = 0
        self.open: list = []
        self.next_id = 0

    def add(self, rec: dict) -> None:
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)


_REC = _Recorder()


def _anchor(tries: int = 3) -> tuple:
    """(epoch ns, ``perf_counter_ns``) of one instant: each try reads
    the wall clock between two monotonic reads, and the tightest try is
    kept, so a preemption between two reads does not shift a root."""
    best = None
    for _ in range(tries):
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, wall, (p0 + p1) // 2)
    return best[1], best[2]


class _Span:
    """One recorded span (see the module docstring)."""

    __slots__ = ("name", "attrs", "device", "id", "parent", "root", "anchor",
                 "counters", "t0", "range", "events")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs = name, attrs
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        rec = _REC
        up = rec.open[-1] if rec.open else None
        self.id = rec.next_id
        rec.next_id += 1
        if up is None:
            # the profiler's time base (epoch ns) against perf_counter_ns
            self.anchor = _anchor()
            self.parent, self.root = None, self.id
        else:
            self.parent, self.root, self.anchor = up.id, up.root, up.anchor
            if self.device is None:
                self.device = up.device
        self.counters = {}
        self.range = None
        self.t0 = time.perf_counter_ns()
        if _profiler_enabled():
            self.range = record_function(self.name)
            self.range.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        rec.open.append(self)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.events[2])
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = _REC
        rec.open.remove(self)
        wall, perf = self.anchor
        rec.add({"name": self.name, "id": self.id, "parent": self.parent,
                 "root": self.root, "start_ns": wall + self.t0 - perf,
                 "end_ns": wall + t1 - perf, "device_ms": None,
                 "counters": self.counters, "attrs": self.attrs,
                 "_events": self.events})
        return False


def span(name: str, device=None, **attrs):
    """A context manager over one stage or phase (module docstring).
    ``device`` (a root's) says where the span's timing events go; its
    children inherit it. Off, the shared no-op context."""
    if not (_REC.forced or _profiler_enabled()):
        return _OFF
    return _Span(name, device, attrs)


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span, if any.
    ``n`` may be a function of no arguments that returns the count, called
    only when a span is open, so a count that costs work is free when
    spans are off. Call it once per solve or call, not once per loop
    iteration."""
    if _REC.open:
        counters = _REC.open[-1].counters
        counters[name] = counters.get(name, 0) + (n() if callable(n) else n)


def enable_spans(on: bool = True) -> None:
    """Record spans without a profiler (on) or only under one (off)."""
    _REC.forced = bool(on)


def spans() -> list:
    """The kept records, oldest first, with ``device_ms`` resolved (each
    end event waited for)."""
    out = []
    for rec in _REC.records:
        ev = rec.pop("_events", None)
        if ev is not None:
            ev[1].synchronize()
            rec["device_ms"] = ev[0].elapsed_time(ev[1])
        out.append(dict(rec))
    return sorted(out, key=lambda r: (r["start_ns"], r["id"]))


def dropped_spans() -> int:
    """Records dropped beyond :data:`MAX_SPANS` since the last reset."""
    return _REC.dropped


def reset_spans() -> None:
    """Forget every kept record (open spans still close into the new
    list)."""
    _REC.records.clear()
    _REC.dropped = 0


@contextlib.contextmanager
def maybe_trace(log_dir: str | None, device: torch.device | None = None):
    """Trace the host and, on a CUDA ``device``, the card's kernels
    inside the block into ``log_dir/trace.json``, and the spans recorded
    inside it into ``log_dir/spans.jsonl``; no-op without a
    ``log_dir``."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    first = _REC.next_id
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
        for rec in spans():
            if rec["id"] >= first:
                f.write(json.dumps(rec) + "\n")
    logger.info("profiler trace -> %s", path)
