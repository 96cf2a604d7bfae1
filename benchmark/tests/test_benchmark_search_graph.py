"""``search_graph_pct.query`` on made-up windows: the share of flat pq
searches that replayed a CUDA graph, and nothing where neither count
moved."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.harness import ROOT, load_module


def _read(launches):
    read = load_module(ROOT, "metrics", "search_graph_pct.query").read
    return read(SimpleNamespace(launches=launches))


@pytest.mark.parametrize("launches,want", [
    ({"pq_search_graph": 412, "pq_search_eager": 0,
      "pq_scan_scores": 32 * 412, "text_tower_graph": 412}, 100.0),
    ({"pq_search_graph": 3, "pq_search_eager": 1}, 75.0),
    ({"pq_search_eager": 5}, 0.0),
])
def test_share_of_graph_replays(launches, want):
    assert _read(launches) == pytest.approx(want)


@pytest.mark.parametrize("launches", [
    {},                                                  # the parent
    {"fused_attn_block": 480, "pq_search_graph": 0,      # an index cell
     "pq_search_eager": 0},
])
def test_nothing_where_neither_count_moved(launches):
    assert _read(launches) is None
