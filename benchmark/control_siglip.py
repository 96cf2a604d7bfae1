"""The control of ``correct`` in the SigLIP cells: what ``emb_gap`` reads
when the work is done in the precision below the configuration's. The
benchmark's runs never run it; the limit lies between the program's
readings and these.

    python3 -m benchmark.control_siglip --workload index-so400m --seeds 1,2,3

As ``benchmark.control`` does for the CLIP index cells: the plain reference
(``reference/siglip.py``) put in the program's place and computed one
precision down, the configuration's bf16 policy in float8 e4m3
(``quant="fp8"``), on the frame pool a run makes, against the f32
reference. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def readings(workload: str, seed: int, device, *, root=None) -> dict:
    """The control's ``emb_gap`` of one SigLIP index cell, for one seed."""
    from benchmark import harness
    from benchmark.checks import embedding_gap
    from benchmark.drivers import encode_siglip

    root = root or harness.ROOT
    bench = harness.load_json(root, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = harness.load_json(root, "benchmark", "configs",
                               cell["config"] + ".json")
    traffic = harness.load_json(root, "benchmark", "traffic",
                                cell["traffic"] + ".json")
    run = harness.Run(workload, cell, config, traffic, {}, seed, 0.0, device)
    ref = encode_siglip.reference_embeddings(run)
    low = encode_siglip.reference_embeddings(run, quant="fp8")
    return {"emb_gap": embedding_gap(low.reshape(-1, low.shape[-1]),
                                     ref.reshape(-1, ref.shape[-1]))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.control_siglip")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": out,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
