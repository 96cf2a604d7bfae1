"""B11 ``pq_scan_scores`` (``csrc/pq_scan.cu``): the window's scans' least
time at the card's peaks over their device time in the trace, in %.

Each search scans every row of the library once for its queries, however
the program splits it into launches: its bytes are the codes once, the int8
LUT of each launch and the f32 scores of its real queries (not the padding
to a power of two), its operations one add a lookup
(``counts.pq_scan_scores``). The driver counts the searches and their
queries (``query_closed.window``)."""

from benchmark import counts
from benchmark.metrics._common import B11, roofline_pct


def read(run):
    searches = run.counters.get("searches", 0)
    calls = run.launches.get("pq_scan_scores", 0)
    if not searches or not calls:
        return None
    p = run.traffic
    half = run.config["vision"]["embed_dim"] // p["dsub"] // 2
    q = run.counters["search_queries"] / searches
    ops, nbytes = counts.pq_scan_scores(p["rows"], half, q)
    nbytes += (calls / searches - 1) * 2 * half * 16 * q
    return roofline_pct(run, B11, searches, ops, nbytes, counts.PEAK_INT8_OPS)
