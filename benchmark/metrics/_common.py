"""What the metric readers share. Not a metric: its name starts with ``_``."""

from __future__ import annotations

import re

from benchmark import counts

# B1 is two launches: attn_core_sm90's qkv projection and attention, then
# gemm_sm90_kernel's out projection with its bias (epilogue 0) or residual
# (epilogue 1) epilogue; the fused MLP's GEMMs carry epilogues 2 and 3
B1 = re.compile(r"attn_core_sm90_kernel|gemm_sm90_kernel<\d+, (\([^)]*\))?[01]>")
B8 = re.compile(r"sdpa_sm90_kernel")
B11 = re.compile(r"pq_scan_onehot_kernel")


def roofline_pct(run, pattern, units: float, ops: float, nbytes: float,
                 peak_ops: float = counts.PEAK_BF16_FLOPS):
    """100 x the least time of ``units`` calls of (ops, nbytes) each at the
    peaks over the device time of the records matching ``pattern`` in the
    traced window; None where there is no trace or no call."""
    if run.trace is None or not units:
        return None
    device_s = run.trace.seconds_matching(pattern)
    if device_s <= 0:
        return None
    bound, _ = counts.bound_s(ops, nbytes, peak_ops)
    return 100.0 * units * bound / device_s


def idle_pct(run):
    """The share of the traced window in which no operation ran on the
    card (the complement of the union of its device records), in %."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def dispatch_ms(run):
    """The host's time to enqueue one batch: the mean of the harness's
    spans around ``Encoder.encode_images_async`` in the window, in ms."""
    spans = [e - s for n, s, e in run.spans if n == "encode_images_async"]
    return 1e3 * sum(spans) / len(spans) if spans else None


def mfu_index(run):
    """The whole step's share of the card's bf16 peak: the image tower's
    model FLOPs an image (``counts.image_tower_flops``, from the
    configuration's shapes) times the window's img/s, over 989 TFLOP/s,
    in %."""
    rate = run.e2e.get("index_img_per_s")
    if not rate:
        return None
    flops = counts.image_tower_flops(run.config["vision"])
    return 100.0 * flops * rate / counts.PEAK_BF16_FLOPS
