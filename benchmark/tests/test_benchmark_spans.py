"""The readers of the program's spans on a made-up window, and the shared
clock on the card (``-m cuda``)."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import ROOT, load_module
from benchmark.trace import Trace
from clipx_torch.utils import profiling

T0 = 100.0  # the window's start on the host clock, s


def _trace(events, start=0.0, stop=10.0):
    t = Trace.__new__(Trace)
    t.start, t.stop_at, t.events = start, stop, events
    return t


def _span(name, start, end, n=1):
    ns = lambda s: round((T0 + s) * 1e9)  # noqa: E731
    return profiling.SpanRecord(name, ns(start), ns(end), 0, 0, 0, 0, n)


# busy [0, 1], [2, 3], [5, 9]: idle (1, 2), (3, 5), (9, 10)
EVENTS = [("k", 0.0, 1.0), ("k", 2.0, 1.0), ("k", 5.0, 4.0)]
SPANS = [
    _span("serve.search", -0.5, 0.2),           # starts before the window
    _span("index.search", -0.4, 0.1),
    _span("serve.search", 0.5, 4.0),
    _span("index.search", 0.6, 1.8),            # idle 0.8
    _span("serve.answer", 2.5, 3.6, n=50),      # idle 0.6
    _span("encoder.encode_texts", 4.0, 6.0),    # idle 1.0 ...
    _span("encoder.encode_texts", 4.5, 5.5),    # ... counted once
    _span("serve.search", 8.5, 9.8),
    _span("index.search", 8.6, 9.5),            # idle 0.5
    _span("serve.answer", 9.5, 9.8, n=50),      # idle 0.3
    _span("serve.search", 10.5, 11.0),          # starts after the window
    _span("index.search", 10.5, 10.9),
    _span("encoder.stage", 0.0, 0.004, n=256),
    _span("encoder.launch", 0.004, 0.016, n=256),
    _span("encoder.stage", 0.02, 0.026, n=256),
    _span("encoder.launch", 0.026, 0.04, n=256),
    _span("encoder.stage", 10.01, 10.09, n=256),  # after the window
]
EXPECTED = {"idle_search_ms.query": 1e3 * (0.8 + 0.5) / 2,
            "idle_answer_ms.query": 1e3 * (0.6 + 0.3) / 2,
            "idle_text_ms.query": 1e3 * 1.0 / 2,
            "stage_ms.b32": 1e3 * (0.004 + 0.006) / 2,
            "launch_ms.b32": 1e3 * (0.012 + 0.014) / 2}


@pytest.fixture
def planted(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(SPANS))


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_value(planted, metric):
    run = SimpleNamespace(trace=_trace(EVENTS), t0=T0)
    got = load_module(ROOT, "metrics", metric).read(run)
    assert got == pytest.approx(EXPECTED[metric], rel=1e-6)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_nothing(monkeypatch, metric):
    """None without a trace, without a span in the window, and on a
    program that has no recorder."""
    read = load_module(ROOT, "metrics", metric).read
    monkeypatch.setattr(profiling, "recorded_spans", lambda: list(SPANS))
    assert read(SimpleNamespace(trace=None, t0=T0)) is None
    late = SimpleNamespace(trace=_trace(EVENTS, 20.0, 30.0), t0=T0)
    assert read(late) is None
    monkeypatch.delattr(profiling, "recorded_spans")
    assert read(SimpleNamespace(trace=_trace(EVENTS), t0=T0)) is None


def test_idle_search_without_queries_reads_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "recorded_spans",
                        lambda: [_span("index.search", 1.0, 2.0)])
    read = load_module(ROOT, "metrics", "idle_search_ms.query").read
    assert read(SimpleNamespace(trace=_trace(EVENTS), t0=T0)) is None


@pytest.mark.cuda
def test_span_holds_the_idle_gap_on_the_card():
    """A program span around a 20 ms host sleep between two kernels and the
    idle gap the device trace finds there agree: spans and device records
    share one clock.

    The card idles from the first kernel's end, which the host's
    synchronize waits for before the span opens, until the second kernel
    starts, which the host launches after the span closes: the gap holds
    the span up to the clocks' disagreement (0.2 ms allowed), and outlasts
    it by the synchronize's and the launch's latencies (0.5 ms allowed;
    0.02-0.30 ms before and 0.12-0.23 ms after on an H100 under CUPTI).
    ``torch.cuda._sleep``'s spin kernel is the trace's primer, which it
    leaves out, so the two kernels are elementwise ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.trace import warm_profiler

    warm_profiler()
    x = torch.ones(1 << 26, device="cuda")
    x.mul_(1.0)
    torch.cuda.synchronize()
    profiling.clear_spans()
    t0 = time.perf_counter()
    trace = Trace(t0)
    x.mul_(1.0)
    torch.cuda.synchronize()
    with profiling.span("host.sleep"):
        time.sleep(0.02)
    x.mul_(1.0)
    trace.stop()
    (span,) = [s for s in profiling.recorded_spans() if s.name == "host.sleep"]
    start, end = span.start_ns / 1e9 - t0, span.end_ns / 1e9 - t0
    a, b = max(trace.idle_gaps(), key=lambda ab: ab[1] - ab[0])
    assert a <= start + 2e-4 and b >= end - 2e-4, (start, end, a, b)
    assert start - a <= 5e-4 and b - end <= 5e-4, (start, end, a, b)
    profiling.clear_spans()
