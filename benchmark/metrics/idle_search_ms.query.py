"""The card's idle ms a query inside the program's ``index.search`` spans
(``VectorIndex.search``: rotation, LUTs, scan, merge, rescore, readback)."""

from benchmark.metrics._spans import idle_ms_per_query


def read(run):
    return idle_ms_per_query(run, "index.search")
