"""B8 ``fused_sdpa_long`` (``csrc/sdpa.cu`` on ``sdpa_sm90.cuh``): its
calls' least time at the card's peaks (``counts.fused_sdpa_long`` at the
cell's batch and the tower's shapes) over their device time in the trace,
in %."""

from benchmark import counts
from benchmark.metrics._common import B8, roofline_pct


def read(run):
    v = run.config["vision"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    ops, nbytes = counts.fused_sdpa_long(run.traffic["batch"], seq,
                                         v["width"], v["heads"])
    return roofline_pct(run, B8,
                        run.launches.get("fused_sdpa_long", 0), ops, nbytes)
