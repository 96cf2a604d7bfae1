"""The benchmark of ``clipx_torch``: ``python3 -m benchmark.run`` (see README.md)."""
