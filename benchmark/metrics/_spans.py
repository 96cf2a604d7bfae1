"""What the readers of the program's own spans share. Not a metric: its
name starts with ``_``.

The program records spans (``clipx_torch/utils/profiling.py``) while a
torch.profiler session runs, as a traced window does, on
``time.perf_counter_ns``: the clock ``benchmark/trace.py`` maps every
device record onto, so spans and idle gaps compare with no conversion.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def window_spans(run) -> Optional[List[Tuple[str, float, float, int]]]:
    """The program's spans that start inside the traced window, as (name,
    start, end, n) in seconds from the window's start; None where there is
    no trace, no span, or a program without the recorder."""
    if run.trace is None or run.trace.stop_at is None:
        return None
    try:
        from clipx_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    out = []
    for s in recorded_spans():
        start = s.start_ns / 1e9 - run.t0
        if run.trace.start <= start <= run.trace.stop_at:
            out.append((s.name, start, s.end_ns / 1e9 - run.t0, s.n))
    return out or None


def mean_ms(run, name: str) -> Optional[float]:
    """The mean duration of the window's ``name`` spans, in ms."""
    spans = window_spans(run) or []
    durations = [e - s for n, s, e, _ in spans if n == name]
    return 1e3 * sum(durations) / len(durations) if durations else None


def union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(b, out[-1][1]))
        elif b > a:
            out.append((a, b))
    return out


def overlap_s(xs, ys) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms_per_query(run, name: str) -> Optional[float]:
    """The card's idle time (``Trace.idle_gaps``) inside the union of the
    window's ``name`` spans, over the queries of its ``serve.search``
    spans, in ms a query."""
    spans = window_spans(run)
    if spans is None:
        return None
    queries = sum(n for s, _, _, n in spans if s == "serve.search")
    if not queries:
        return None
    held = union((s, e) for n, s, e, _ in spans if n == name)
    return 1e3 * overlap_s(run.trace.idle_gaps(), held) / queries
