"""Time the coded-tier load chain phase by phase.

    python -m clipx_torch.tools.load_timing --index PATH --corpus-dtype int8
        [--search-mode ivf] [--cold] [--json OUT] [--query] [--device cpu]

Counterpart of the root ``tools/load_timing.py``, with its flags (plus
``--device``, default ``cuda``) and its ``--json`` keys; ``platform`` is
the device type the index lives on (``cuda`` or ``cpu``). Phases reported:

- cold (``--cold`` forces CLIPX_CODES=refresh): f32 sidecar read + host
  quantize/train/encode + codes-file write + device placement, what every
  start paid before the codes file existed;
- warm: codes-file validation + memmap + device placement only, what a
  start pays now.

Also reports peak host RSS and (with ``--query``) the p50 of 50 searches
after the load, so the record shows that the loaded index serves.
``CLIPX_CODES`` is restored on exit: ``main`` is also library API.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time

from clipx_torch.runtime.device import DEVICES
from clipx_torch.utils.env import restoring


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="load_timing")
    ap.add_argument("--index", default="images.index")
    ap.add_argument("--corpus-dtype", default="int8",
                    choices=("f32", "bf16", "int8", "int4", "pq"))
    ap.add_argument("--search-mode", default="auto",
                    choices=("exact", "quant", "auto", "ivf"))
    ap.add_argument("--sharded", default="off",
                    choices=("auto", "on", "off"))
    ap.add_argument("--cold", action="store_true",
                    help="force a rebuild (CLIPX_CODES=refresh): "
                         "measures the pre-persistence start cost and "
                         "rewrites the codes sidecar")
    ap.add_argument("--query", action="store_true",
                    help="also run 50 searches and report p50 (proves "
                         "the loaded index serves)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where the index is placed (default cuda; cpu "
                         "must be asked for)")
    args = ap.parse_args(argv)

    from clipx_torch.cli import common

    common.check_device(args)
    if args.cold:
        with restoring(CLIPX_CODES="refresh"):
            return _run(args)
    return _run(args)


def _run(args) -> int:
    import numpy as np

    from clipx_torch.cli import common

    t0 = time.time()
    idx = common.load_index(args)
    # one search waits for the placement to finish (its results are
    # copied to the host)
    idx.search(np.zeros((1, idx.dim), np.float32), 1)
    load_s = time.time() - t0
    rss_gib = resource.getrusage(resource.RUSAGE_SELF
                                 ).ru_maxrss / (1 << 20)
    out = {
        "index": args.index,
        "ntotal": int(idx.ntotal),
        "dim": int(idx.dim),
        "corpus_dtype": args.corpus_dtype,
        "search_mode": args.search_mode,
        "mode": "cold" if args.cold else "warm",
        "load_plus_first_search_s": round(load_s, 2),
        "peak_host_rss_gib": round(rss_gib, 2),
        "platform": args.device,
    }
    if args.query:
        rng = np.random.RandomState(1)
        lat = []
        for _ in range(50):
            q = rng.randn(1, idx.dim).astype(np.float32)
            q /= np.linalg.norm(q)
            t = time.time()
            idx.search(q, 50)
            lat.append(time.time() - t)
        out["query_p50_ms"] = round(float(np.median(lat)) * 1000, 2)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
