"""``_common.idle_pct``: the traced window's share with the card idle."""

from benchmark.metrics._common import idle_pct as read  # noqa: F401
