"""B8 ``fused_sdpa_long`` at SigLIP's head dim 72 (``csrc/sdpa_sm90.cuh``'s
D = 72 instance): its calls' least time at the card's peaks
(``counts_siglip.fused_sdpa_long`` at the cell's batch, 729 tokens and the
real head dim) over their device time in the trace, in %; the calls counted
by ``LAUNCHES["fused_sdpa_long"]``."""

from benchmark import counts_siglip
from benchmark.metrics._common import B8, roofline_pct


def read(run):
    v = run.config["vision"]
    seq = (v["image_size"] // v["patch_size"]) ** 2
    ops, nbytes = counts_siglip.fused_sdpa_long(
        run.traffic["batch"], seq, v["heads"], v["width"] // v["heads"])
    return roofline_pct(run, B8,
                        run.launches.get("fused_sdpa_long", 0), ops, nbytes)
