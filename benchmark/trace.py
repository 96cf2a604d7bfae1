"""The device trace of a run's window: torch.profiler with CUDA activity
only, so the host pays no per-operator record and the window runs as it
does untraced, but for CUPTI's per-kernel cost.

Every device record (kernels, copies, sets) becomes an interval on the
run's host clock (``time.perf_counter``, seconds from the window's start).
From them: the busy time (the union of the intervals), the kernels' time
by name, and the idle gaps, each named by the harness's host spans that
were open at its middle.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

# torch.cuda._sleep's kernel opens each session and is left out: on the
# H100 a profiler session has been seen to drop the first kernel it sees
PRIMER = "spin_kernel"


def warm_profiler() -> None:
    """One short session, in set-up: the first session of a process
    initialises CUPTI, which must not fall inside the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1)
        torch.cuda.synchronize()


class Trace:
    """A profiler session around a window; ``stop`` reads it."""

    def __init__(self, t0: float):
        from torch.profiler import ProfilerActivity, profile

        self.t0 = t0
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        # one reading of each clock the profiler may stamp its records with
        self._anchor = (time.perf_counter_ns(), time.time_ns(),
                        time.monotonic_ns())
        torch.cuda._sleep(1)
        self.start = time.perf_counter() - t0
        self.events: List[Tuple[str, float, float]] = []
        self.stop_at: Optional[float] = None

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.stop_at = time.perf_counter() - self.t0
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        results = self._prof.profiler.kineto_results
        raw = [(e.name(), e.start_ns(), e.duration_ns())
               for e in results.events()
               if e.device_type() == DeviceType.CUDA and PRIMER not in e.name()]
        pc, wall, mono = self._anchor
        ref = results.trace_start_ns() if hasattr(
            results, "trace_start_ns") else min(s for _, s, _ in raw)
        # the clock whose reading at the start lies nearest the trace's own
        clock = wall if abs(ref - wall) < abs(ref - mono) else mono
        shift = pc - clock - int(self.t0 * 1e9)
        self.events = [(name, (s + shift) / 1e9, d / 1e9)
                       for name, s, d in raw]
        self._prof = None

    # -- readings -------------------------------------------------------------
    @property
    def window_s(self) -> float:
        return self.stop_at - self.start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device records inside the traced window."""
        spans = sorted((max(s, self.start), min(s + d, self.stop_at))
                       for _, s, d in self.events)
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, d in self.events:
            out[name] = out.get(name, 0.0) + d
        return out

    def seconds_matching(self, pattern) -> float:
        """Device seconds of the records whose name matches ``pattern`` (a
        compiled regular expression)."""
        return sum(d for name, _, d in self.events if pattern.search(name))

    def idle_gaps(self) -> List[Tuple[float, float]]:
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.stop_at]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def breakdown(self, spans) -> dict:
        """The ten device operations with the most time, and the ten
        longest idle gaps, each named by the host spans open at its middle
        (``spans``: (name, start, end) on the same clock)."""
        ops = sorted(self.kernel_seconds().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_gaps(), key=lambda ab: ab[0] - ab[1])[:10]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            open_ = sorted({n for n, s, e in spans if s <= mid <= e})
            named.append([f"{'+'.join(open_) or 'no span'} at {a:.4f} s",
                          b - a])
        return {"device_ops": [[n[:160], s] for n, s in ops[:10]],
                "idle_gaps": named}
