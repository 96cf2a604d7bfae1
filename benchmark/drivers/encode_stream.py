"""Traffic driver ``encode_stream``: the indexer's encode stage.

Uint8 frames at the model's input size, made from the seed as a pool of
``pool_batches`` batches of ``batch`` images, go through
``Encoder.encode_images_async`` with ``depth`` batches in flight, then
``Encoder.finalize``, as ``cli/build_index.py`` runs them (``PIPELINE_DEPTH``):
after each enqueue, the oldest batch beyond ``depth`` is finalised. The
pool is cycled for the whole window. JPEG decode and the store write, the
indexer's host layers, are not part of this traffic.

``index_img_per_s`` is every image enqueued before the window's close over
the time from the window's start until the last of them reached the host:
all the work and all the time, with no batch cut at the close. Every embedding returned, the drained
batches included, is compared with the plain reference's f32 embedding of
its frame.

Parameters: ``batch``, ``depth``, ``pool_batches``.
"""

from __future__ import annotations

import collections
import time

from benchmark import corpus, weights
from benchmark.checks import embedding_gap


def program_config(config: dict):
    """The port's CLIPConfig with the configuration file's sizes."""
    from clipx_torch.config import CLIPConfig, TextConfig, VisionConfig

    return CLIPConfig(
        name=config["name"], vision=VisionConfig(**config["vision"]),
        text=TextConfig(**config["text"]), quick_gelu=config["quick_gelu"],
        layernorm_eps=config["layernorm_eps"],
        image_mean=tuple(config["image_mean"]),
        image_std=tuple(config["image_std"]))


def make_encoder(run):
    """The port's Encoder on the seeded weights. ``run.compute_quant``
    (the control) takes the program's W8A8 path, which quantizes host
    arrays, as it does a checkpoint's."""
    from clipx_torch.runtime.encoder import Encoder

    with run.stage("weights"):
        params = weights.make_params(run.config, run.seed, run.device)
    with run.stage("encoder"):
        if run.compute_quant:
            params = weights.to_host(params)
        return Encoder(program_config(run.config), params, device=run.device,
                       compute_quant=run.compute_quant)


def setup(run):
    p = run.traffic
    enc = make_encoder(run)
    size = run.config["vision"]["image_size"]
    with run.stage("frames"):
        pool = corpus.frames(run.seed, p["pool_batches"] * p["batch"], size,
                             run.device).cpu().numpy()
        pool = [pool[i * p["batch"]: (i + 1) * p["batch"]]
                for i in range(p["pool_batches"])]
    with run.stage("warmup"):
        enc.warmup(buckets=[p["batch"]])
        # the window's pipeline once: its pinned host buffers, one a batch
        # in flight, are allocated here and not inside the window
        handles = [enc.encode_images_async(pool[i % len(pool)])
                   for i in range(p["depth"] + 1)]
        for handle in handles:
            enc.finalize(handle)
    return {"enc": enc, "pool": pool}


def window(run, state) -> None:
    p = run.traffic
    enc, pool = state["enc"], state["pool"]
    end = run.t0 + run.seconds
    in_flight = collections.deque()
    done = []  # (pool index, embeddings, time finalised)
    sent = 0

    def finalize_one():
        j, handle = in_flight.popleft()
        t = time.perf_counter()
        emb = enc.finalize(handle)
        t2 = time.perf_counter()
        run.span("finalize", t, t2)
        done.append((j, emb, t2))

    while time.perf_counter() < end:
        j = sent % len(pool)
        t = time.perf_counter()
        handle = enc.encode_images_async(pool[j])
        run.span("encode_images_async", t, time.perf_counter())
        in_flight.append((j, handle))
        sent += 1
        if len(in_flight) > p["depth"]:
            finalize_one()
    while in_flight:
        finalize_one()
    n = p["batch"]
    run.attempted = sent * n
    run.e2e["index_img_per_s"] = sent * n / (done[-1][2] - run.t0)
    run.notes["batches"] = sent
    run.data["done"] = done


def release(run, state) -> None:
    state.clear()


def check(run) -> dict:
    """The worst L2 distance between a returned embedding and the
    reference's f32 embedding of its frame."""
    from benchmark.reference.clip import encode_images

    p = run.traffic
    done = run.data["done"]
    size = run.config["vision"]["image_size"]
    frames = corpus.frames(run.seed, p["pool_batches"] * p["batch"], size,
                           run.device)
    params = weights.make_params(run.config, run.seed, run.device)
    ref = encode_images(params, run.config, frames,
                        chunk=p.get("reference_chunk", 32)).cpu().numpy()
    del params, frames
    ref = ref.reshape(p["pool_batches"], p["batch"], -1)
    gap = max(embedding_gap(emb, ref[j]) for j, emb, _ in done)
    return {"emb_gap": {"value": gap, "limit": run.limits["emb_gap"]}}
