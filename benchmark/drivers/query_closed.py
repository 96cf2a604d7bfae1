"""Traffic driver ``query_closed``: text queries against the HTTP
service's search path, in a closed loop, over a pq library made from the
seed.

Set-up writes the library as a codes-only ``<index>.codes`` file
(``corpus.write_codes_file``: ``rows`` rows of ``dim / dsub`` 4-bit codes
and a stored rotation) under ``$TMPDIR``, with an empty store beside it,
and boots the service on it as a deployment does: ``serve.make_server``
with its warm-up, which builds the kernels and runs every text and search
shape a request reaches (``env`` in the traffic file narrows the search
warm-up to this traffic's k). The codes file goes once the service holds
the library on the card.

The window: ``clients`` threads, each sending its next query when its
last one is answered, each query a prompt drawn from a pool of
``prompt_pool`` seeded prompts. A query is ``/search?q=``'s two calls
without HTTP (``serve.py``'s handler): ``SearchService.encode_texts([q])``
then ``SearchService.search(features, k)``, each through its coalescer
unless the traffic's ``env`` turns them off (``CLIPX_SERVE_COALESCE=0``). ``query_qps`` is every query sent before the
window's close that was answered, over the time from the window's start
until the last answer: all the work and all the time. An exception counts
as failed.

Every answered query is checked: its text embedding against the plain
reference's f32 embedding of its prompt, and its top-k against the
reference's exact PQ top-k for the program's own query embedding (the
search stage is checked on its input, the text stage on its own).

Parameters: ``clients``, ``k``, ``rows``, ``dsub``, ``prompt_pool``,
``words`` and ``letters`` (each [least, most]).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from benchmark import corpus
from benchmark.checks import FAIL, embedding_gap, ranking_gap
from benchmark.drivers.encode_stream import make_encoder


def _workdir(run) -> str:
    return os.path.join(tempfile.gettempdir(), "clipx-benchmark",
                        run.workload)


def _library(run):
    p, dim = run.traffic, run.config["vision"]["embed_dim"]
    return corpus.pq_library(run.seed, p["rows"], dim, p["dsub"], run.device)


def _prompts(run):
    p = run.traffic
    return corpus.prompts(run.seed, p["prompt_pool"], p["words"],
                          p["letters"])


def setup(run):
    from clipx_torch import serve

    enc = make_encoder(run)
    if enc.tokenizer.has_learned_merges:
        raise RuntimeError("the port found a BPE merge table; the reference "
                           "tokenizes without one")
    work = _workdir(run)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    index = os.path.join(work, "images.index")
    with run.stage("library"):
        codes, centroids, rotation = _library(run)
        codes = codes.cpu().numpy()
    with run.stage("codes_file"):
        run.notes["codes_file_bytes"] = corpus.write_codes_file(
            index + ".codes", codes, centroids.cpu().numpy(),
            rotation.cpu().numpy(), run.traffic["dsub"])
        del codes, centroids, rotation
    args = serve.build_parser().parse_args([
        "--model", run.config["name"], "--db", os.path.join(work, "db"),
        "--index", index, "--corpus-dtype", "pq", "--device",
        run.device.type, "--sharded", "off", "--port", "0", "--warmup"])
    with run.stage("boot"):
        server = serve.make_server(args, encoder=enc)
        service = server.RequestHandlerClass.service
    with run.stage("warmup"):
        warm = getattr(server, "_warmup_thread", None)
        if warm is not None:
            warm.join()
    os.unlink(index + ".codes")
    return {"server": server, "service": service, "prompts": _prompts(run),
            "work": work}


def window(run, state) -> None:
    p = run.traffic
    service, prompts = state["service"], state["prompts"]
    k = p["k"]
    end = run.t0 + run.seconds
    before = service.metrics()
    results = []   # (prompt index, embedding, D, I, start, end, misses)
    errors = []
    lock = threading.Lock()

    def client(c):
        rng = np.random.default_rng(corpus.stream(
            run.seed * 1024 + c, corpus.STREAM_CLIENTS))
        mine, spans, failed = [], [], []
        while time.perf_counter() < end:
            j = int(rng.integers(len(prompts)))
            t = time.perf_counter()
            try:
                feats = service.encode_texts([prompts[j]])
                t2 = time.perf_counter()
                res = service.search(feats, k)
            except Exception as exc:  # noqa: BLE001 — a failed query
                failed.append(repr(exc))
                continue
            t3 = time.perf_counter()
            spans += [("encode_texts", t, t2), ("search", t2, t3)]
            rows = res["results"]
            mine.append((j, feats[0],
                         np.array([r["score"] for r in rows], np.float32),
                         np.array([r["id"] for r in rows], np.int64),
                         t, t3, sum(r["path"] is None for r in rows)))
        with lock:
            results.extend(mine)
            errors.extend(failed)
            for name, a, b in spans:
                run.span(name, a, b)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(p["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    after = service.metrics()
    run.attempted = len(results) + len(errors)
    run.failed = len(errors)
    run.e2e["query_qps"] = (len(results) / (max(r[5] for r in results)
                                            - run.t0) if results else 0.0)
    # searches and their queries: the search coalescer's batches where it
    # runs, otherwise one search a query
    batches = after["coalesce"]["batches"] - before["coalesce"]["batches"]
    run.counters["searches"] = batches or len(results)
    run.counters["search_queries"] = (
        after["coalesce"]["queries"] - before["coalesce"]["queries"]
        if batches else len(results))
    run.data["latencies_s"] = [r[5] - r[4] for r in results]
    run.notes["store_misses"] = sum(r[6] for r in results)
    run.notes["errors"] = errors[:5]
    run.data["results"] = results


def release(run, state) -> None:
    state["service"].close()
    state["service"].env.close()
    state["server"].server_close()
    shutil.rmtree(state["work"], ignore_errors=True)
    state.clear()


def reference_texts(run, prompts, quant=""):
    from benchmark import weights
    from benchmark.reference.clip import encode_texts, tokenize

    params = weights.make_params(run.config, run.seed, run.device)
    ids = tokenize(prompts, run.config["text"]["context_length"])
    return encode_texts(params, run.config, ids.to(run.device), quant=quant)


def search_numbers(run, queries, d_got, i_got, dtype=torch.float32):
    """The ranking gap of answers (d_got, i_got) to ``queries`` (user
    space), against the reference's exact top-k over the library."""
    from benchmark.reference import pq

    codes, centroids, rotation = _library(run)
    q_rot = pq.rotate(torch.from_numpy(np.asarray(queries)).to(run.device),
                      rotation)
    k = run.traffic["k"]
    d_ref, _ = pq.top_k(codes, centroids, q_rot, k, dtype=dtype)
    ids = torch.from_numpy(np.clip(i_got, 0, codes.shape[0] - 1))
    s_got = pq.row_scores(codes, centroids, q_rot, ids.to(run.device))
    return ranking_gap(d_got, i_got, d_ref.cpu().numpy(),
                       s_got.cpu().numpy(), codes.shape[0])


def check(run) -> dict:
    results = run.data["results"]
    lim = run.limits
    if not results:
        return {"text_gap": {"value": FAIL, "limit": lim["text_gap"]},
                "score_gap": {"value": FAIL, "limit": lim["score_gap"]}}
    prompts = _prompts(run)
    order = sorted({r[0] for r in results})
    ref = reference_texts(run, [prompts[j] for j in order]).cpu().numpy()
    at = {j: i for i, j in enumerate(order)}
    got = np.stack([r[1] for r in results])
    text_gap = embedding_gap(got, ref[[at[r[0]] for r in results]])
    k = run.traffic["k"]
    shapes_ok = all(r[2].shape == (k,) and r[3].shape == (k,)
                    for r in results)
    score_gap = FAIL
    if shapes_ok:
        score_gap = search_numbers(run, got, np.stack([r[2] for r in results]),
                                   np.stack([r[3] for r in results]))
    return {"text_gap": {"value": text_gap, "limit": lim["text_gap"]},
            "score_gap": {"value": score_gap, "limit": lim["score_gap"]}}
