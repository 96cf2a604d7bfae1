"""The device trace's arithmetic on made-up records: the busy union, the
idle gaps and their names."""

from __future__ import annotations

import re

from benchmark.trace import Trace


def _trace(events, start=0.0, stop=10.0):
    t = Trace.__new__(Trace)
    t.start, t.stop_at, t.events = start, stop, events
    return t


def test_busy_is_the_union_inside_the_window():
    t = _trace([("a", 1.0, 2.0), ("b", 2.5, 1.0), ("c", 5.0, 1.0),
                ("d", 9.5, 2.0), ("e", -1.0, 1.5)])
    assert t.busy_intervals() == [(0.0, 0.5), (1.0, 3.5), (5.0, 6.0),
                                  (9.5, 10.0)]
    assert t.busy_s() == 0.5 + 2.5 + 1.0 + 0.5
    assert t.idle_gaps() == [(0.5, 1.0), (3.5, 5.0), (6.0, 9.5)]


def test_breakdown_names_gaps_by_open_spans():
    t = _trace([("k1", 0.0, 1.0), ("k2", 4.0, 1.0), ("k1", 6.0, 4.0)])
    spans = [("finalize", 1.5, 3.8), ("encode_texts", 5.0, 5.9),
             ("search", 5.2, 6.5)]
    b = t.breakdown(spans)
    assert b["device_ops"] == [["k1", 5.0], ["k2", 1.0]]
    assert b["idle_gaps"][0] == ["finalize at 1.0000 s", 3.0]
    assert b["idle_gaps"][1][0] == "encode_texts+search at 5.0000 s"


def test_seconds_matching():
    t = _trace([("void attn_core_sm90_kernel(x)", 0, 1.0),
                ("gemm_sm90_kernel<128, 0>(y)", 1, 0.5),
                ("gemm_sm90_kernel<128, 2>(z)", 2, 0.25)])
    from benchmark.metrics._common import B1

    assert t.seconds_matching(B1) == 1.5
    assert t.seconds_matching(re.compile("nothing")) == 0
