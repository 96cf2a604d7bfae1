"""B1 ``fused_attn_block`` (``csrc/attn_block.cu``): its calls' least time
at the card's peaks (``counts.fused_attn_block`` at the cell's batch and
the tower's shapes) over their device time in the trace, in %."""

from benchmark import counts
from benchmark.metrics._common import B1, roofline_pct


def read(run):
    v = run.config["vision"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    ops, nbytes = counts.fused_attn_block(run.traffic["batch"], seq,
                                          v["width"], v["heads"])
    return roofline_pct(run, B1,
                        run.launches.get("fused_attn_block", 0), ops, nbytes)
