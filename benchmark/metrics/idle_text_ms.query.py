"""The card's idle ms a query inside the program's ``encoder.encode_texts``
spans (the tokenizer, the text tower's launches, the readback)."""

from benchmark.metrics._spans import idle_ms_per_query


def read(run):
    return idle_ms_per_query(run, "encoder.encode_texts")
