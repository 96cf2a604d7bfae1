"""``_common.mfu_index``: the image tower's share of the bf16 peak."""

from benchmark.metrics._common import mfu_index as read  # noqa: F401
