"""``_common.dispatch_ms``: the host's ms to enqueue one batch."""

from benchmark.metrics._common import dispatch_ms as read  # noqa: F401
