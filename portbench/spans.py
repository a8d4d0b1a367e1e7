"""What the per-layer metrics read from the program's own spans and
counters: the records ``fgt_tpu_torch.utils.profiling`` keeps while a
profiler records, here the run's profiled stretch after the window (the
only stretch of a run under a profiler: ``profile_clips`` clips or
``profile_steps`` steps). Each value is a mean over the stretch's roots
(``inpaint`` a clip, ``fgt_step`` a step). A program that keeps no such
records, or a run that recorded no root, gives ``None``."""

from __future__ import annotations

ROOTS = {"infer": "inpaint", "train": "fgt_step"}


def _records(ctx: dict, kind: str):
    """A traced run of ``kind``'s records under its roots, and the
    number of roots; None where there are none."""
    if ctx["kind"] != kind or "trace" not in ctx:
        return None
    try:
        from fgt_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    recs = spans()
    roots = {r["id"] for r in recs
             if r["parent"] is None and r["name"] == ROOTS[kind]}
    if not roots:
        return None
    return [r for r in recs if r["root"] in roots], len(roots)


def span_ms(ctx: dict, kind: str, name: str, host: bool = False):
    """Milliseconds a root in the spans called ``name``: their
    ``device_ms`` (the interval between the span's events on the card),
    or with ``host``, or where a span has none (a run without a card),
    their host duration. None where no such span was recorded."""
    got = _records(ctx, kind)
    if got is None:
        return None
    recs, n_roots = got
    mine = [r for r in recs if r["name"] == name]
    if not mine:
        return None
    total = sum((r["end_ns"] - r["start_ns"]) / 1e6
                if host or r["device_ms"] is None else r["device_ms"]
                for r in mine)
    return total / n_roots, "ms/step" if kind == "train" else "ms/clip"


def counter(ctx: dict, kind: str, name: str, unit: str):
    """Counter ``name`` summed over the spans of the roots, a root. None
    where no span counted it."""
    got = _records(ctx, kind)
    if got is None:
        return None
    recs, n_roots = got
    values = [r["counters"][name] for r in recs if name in r["counters"]]
    if not values:
        return None
    return sum(values) / n_roots, unit
