"""The card's idle ms a query inside the program's ``serve.answer`` spans
(``SearchService.search``'s store lookups of the k rows)."""

from benchmark.metrics._spans import idle_ms_per_query


def read(run):
    return idle_ms_per_query(run, "serve.answer")
