"""Tracing / profiling utilities (the port's copy of clipx.utils.profiling).

Every indexer stage (scan, encode dispatch and wait, writeback, index
build) is timed and the per-stage throughput is emitted on stderr, so the
reference's stdout contract stays byte-compatible. ``device_trace`` wraps
``torch.profiler`` when a trace directory is given and is a no-op
otherwise.

``span(name, n)`` marks a layer boundary of the program (the encoder's
staging copy and launches, a text encode, a search and its answer). Spans
record only while a ``torch.profiler`` session runs, whatever its
activities; with none, ``span`` returns one shared no-op context and
reads no clock. A record holds its name, its start and end on
``time.perf_counter_ns`` (the clock a profiler session's device records
can be mapped onto), its id, the id of the span open around it on the same
thread, the id of its root span (shared by every span of one call), the
thread and ``n``, the items it handled. Records stay in memory, at most
``SPAN_CAP`` of them; ``device_trace`` writes its session's into
``trace.json`` beside the kernels.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import OrderedDict
from typing import Iterator, List, NamedTuple, Optional

from torch.autograd import profiler as _torch_profiler


class StageTimers:
    """Accumulates wall time and item counts per named stage."""

    def __init__(self) -> None:
        self._acc: "OrderedDict[str, float]" = OrderedDict()
        self._items: "OrderedDict[str, int]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0, items)

    def record(self, name: str, seconds: float, items: int = 0) -> None:
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        self._items[name] = self._items.get(name, 0) + items

    def summary(self) -> str:
        rows = []
        for name, secs in self._acc.items():
            n = self._items.get(name, 0)
            rate = f" ({n / secs:,.1f}/s)" if n and secs > 0 else ""
            count = f" n={n}" if n else ""
            rows.append(f"{name}: {secs:.3f}s{count}{rate}")
        return "; ".join(rows)

    def emit(self, prefix: str = "[stats] ") -> None:
        if self._acc:
            print(prefix + self.summary(), file=sys.stderr, flush=True)


# -- spans --------------------------------------------------------------------

SPAN_CAP = 1 << 20


class SpanRecord(NamedTuple):
    """One finished span; ``parent`` is 0 for a root, whose ``root`` is its
    own ``id``."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    root: int
    thread: int
    n: int


class _Span:
    """One open span; ``n`` may be set inside it."""

    __slots__ = ("_rec", "_stack", "name", "n", "id", "parent", "root",
                 "start_ns")

    def __init__(self, rec: "SpanRecorder", name: str, n: int):
        self._rec, self.name, self.n = rec, name, n

    def __enter__(self) -> "_Span":
        self._stack = self._rec._thread_stack()
        self.id = next(self._rec._ids)
        if self._stack:
            outer = self._stack[-1]
            self.parent, self.root = outer.id, outer.root
        else:
            self.parent, self.root = 0, self.id
        self._stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.perf_counter_ns()
        self._stack.pop()
        self._rec._add(SpanRecord(self.name, self.start_ns, end_ns, self.id,
                                  self.parent, self.root,
                                  threading.get_ident(), self.n))
        return False


_OFF = contextlib.nullcontext()


class SpanRecorder:
    """The spans of one process (``RECORDER``), or of a test's own."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self._records: List[SpanRecord] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def span(self, name: str, n: int = 0):
        """A context that records ``name`` while a torch.profiler session
        runs; the shared no-op context (entered as None) otherwise."""
        if not _torch_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name, n)

    def _thread_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._records) < self.cap:
                self._records.append(record)
            else:
                self._dropped += 1

    def records(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._records)

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0


RECORDER = SpanRecorder()
span = RECORDER.span
recorded_spans = RECORDER.records
dropped_spans = RECORDER.dropped
clear_spans = RECORDER.clear


def _chrome_span_events(spans, anchor, trace_events,
                        base_ns: int) -> List[dict]:
    """``spans`` as Chrome complete events on the profiler's timestamps:
    ``anchor`` is (perf_counter_ns, time_ns, monotonic_ns) read at one
    instant; the profiler stamps its records with the wall or the monotonic
    clock, whichever its events lie nearer, in µs after ``base_ns``."""
    pc, wall, mono = anchor
    stamps = [ev["ts"] for ev in trace_events
              if ev.get("ph") == "X" and "ts" in ev]
    ref = base_ns + 1e3 * min(stamps) if stamps else wall
    clock = wall if abs(ref - wall) < abs(ref - mono) else mono
    shift = clock - pc - base_ns
    return [{"ph": "X", "cat": "program_span", "name": s.name,
             "pid": "clipx_torch spans", "tid": s.thread,
             "ts": (s.start_ns + shift) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "root": s.root,
                      "n": s.n}}
            for s in spans]


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace (CPU and CUDA activity) written as a Chrome
    trace into ``trace_dir`` when one is given; a no-op otherwise. The
    spans recorded in the session go into the same file, on a track of
    their own (process ``clipx_torch spans``, one thread a recording
    thread)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        anchor = (time.perf_counter_ns(), time.time_ns(),
                  time.monotonic_ns())
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    spans = [s for s in recorded_spans() if s.start_ns >= anchor[0]]
    if not spans:
        return
    with open(path) as f:
        trace = json.load(f)
    events = trace.setdefault("traceEvents", [])
    events += _chrome_span_events(spans, anchor, events,
                                  int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
