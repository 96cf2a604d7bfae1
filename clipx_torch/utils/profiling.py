"""Tracing / profiling utilities (the port's copy of clipx.utils.profiling).

Every indexer stage (scan, encode dispatch and wait, writeback, index
build) is timed and the per-stage throughput is emitted on stderr, so the
reference's stdout contract stays byte-compatible. ``device_trace`` wraps
``torch.profiler`` when a trace directory is given and is a no-op
otherwise.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import OrderedDict
from typing import Iterator, Optional


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


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace (CPU and CUDA activity) written as a Chrome
    trace into ``trace_dir`` when one is given; a no-op otherwise."""
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
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
