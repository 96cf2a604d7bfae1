"""The control of ``correct``: what a cell's numbers read when the work is
done in the precision below the configuration's. The benchmark's runs
never run it; each limit lies between the program's readings and these.

    python3 -m benchmark.control --workload <name> --seeds 1,2,3 \
        [--queries 1024] [--program-int8 --seconds 2]

The configurations state bf16 compute: weights and activations stored in
bf16, f32 accumulation and statistics. The control is the plain reference
put in the program's place and computed one precision down, the same
policy in float8 e4m3 (``reference/clip.py``, ``quant="fp8"``), on the
inputs a run makes:

- an index cell: the embeddings of its frame pool against the f32
  reference's, ``emb_gap``;
- the query cell: ``--queries`` prompts drawn from its pool, the text tower
  in fp8 against f32, ``text_gap``; and the exact top-k of the f32 queries
  scored in bf16 (the search's f32 scores one precision down) against the
  f32 scoring, ``score_gap``.

``--program-int8`` also runs an index cell whole on the program's own
int8 path (``--compute int8``: the image tower's MLP in W8A8), with a
``--seconds`` window, and reports its ``emb_gap`` as ``program_int8``.
Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _cell(root, workload):
    from benchmark import harness

    bench = harness.load_json(root, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    return (cell, harness.load_json(root, "benchmark", "configs",
                                    cell["config"] + ".json"),
            harness.load_json(root, "benchmark", "traffic",
                              cell["traffic"] + ".json"))


def _index_control(run) -> dict:
    from benchmark import corpus, weights
    from benchmark.checks import embedding_gap
    from benchmark.reference.clip import encode_images

    p = run.traffic
    frames = corpus.frames(run.seed, p["pool_batches"] * p["batch"],
                           run.config["vision"]["image_size"], run.device)
    params = weights.make_params(run.config, run.seed, run.device)
    chunk = p.get("reference_chunk", 32)
    ref = encode_images(params, run.config, frames, chunk=chunk)
    low = encode_images(params, run.config, frames, chunk=chunk, quant="fp8")
    return {"emb_gap": embedding_gap(low.cpu().numpy(), ref.cpu().numpy())}


def _query_control(run, queries: int) -> dict:
    from benchmark.checks import embedding_gap
    from benchmark.drivers import query_closed as qc
    from benchmark.reference import pq

    rng = np.random.default_rng(run.seed)
    prompts = qc._prompts(run)
    pick = [prompts[j] for j in rng.integers(len(prompts), size=queries)]
    ref = qc.reference_texts(run, pick)
    out = {"text_gap": embedding_gap(
        qc.reference_texts(run, pick, quant="fp8").cpu().numpy(),
        ref.cpu().numpy())}
    codes, centroids, rotation = qc._library(run)
    d_low, i_low = pq.top_k(codes, centroids, pq.rotate(ref, rotation),
                            run.traffic["k"], dtype=torch.bfloat16)
    del codes, centroids, rotation
    out["score_gap"] = qc.search_numbers(run, ref.cpu().numpy(),
                                         d_low.cpu().numpy(),
                                         i_low.cpu().numpy())
    return out


def readings(workload: str, seed: int, device, *, queries: int = 1024,
             program_int8: bool = False, seconds: float = 2.0,
             root=None) -> dict:
    """The control's reading of each number of one cell, for one seed."""
    from benchmark import harness

    root = root or harness.ROOT
    cell, config, traffic = _cell(root, workload)
    run = harness.Run(workload, cell, config, traffic, {}, seed, 0.0, device)
    if traffic["driver"] == "query_closed":
        return _query_control(run, queries)
    out = _index_control(run)
    if program_int8:
        res, _ = harness.run_cell(workload, seed, seconds, False, device=device,
                               started=time.perf_counter(), root=root,
                               compute_quant="int8")
        out["program_int8"] = res["checks"]["emb_gap"]["value"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--program-int8", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(args.workload, seed, torch.device("cuda", 0),
                       queries=args.queries, program_int8=args.program_int8,
                       seconds=args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": out,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
