"""The whole query's share of the card's peaks: for each answered query,
the text tower's model FLOPs over the bf16 peak plus the scan's lookups
(one add for each of the library's rows and subspaces) over the int8 peak,
times the window's queries a second, in %."""

from benchmark import counts


def read(run):
    rate = run.e2e.get("query_qps")
    if not rate:
        return None
    p = run.traffic
    subspaces = run.config["vision"]["embed_dim"] // p["dsub"]
    seconds = (counts.text_tower_flops(run.config["text"])
               / counts.PEAK_BF16_FLOPS
               + p["rows"] * subspaces / counts.PEAK_INT8_OPS)
    return 100.0 * seconds * rate
