"""Traffic driver ``encode_siglip``: the indexer's encode stage with SigLIP.

``encode_stream``'s traffic on a SigLIP configuration: uint8 frames at the
model's input size, made from the seed as a pool of ``pool_batches``
batches of ``batch`` images, go through ``Encoder.encode_images_async``
with ``depth`` batches in flight, then ``Encoder.finalize``. ``window`` and
``release`` are ``encode_stream``'s, so ``index_img_per_s`` is measured the
same way. Set-up builds the port's Encoder on the SigLIP configuration of
the file and on ``weights_siglip``'s seeded tree, then warms up as
``encode_stream`` does; a program without SigLIP fails there at once. The
check compares every returned embedding with ``reference/siglip.py``'s f32
embedding of its frame.

Parameters: ``batch``, ``depth``, ``pool_batches``, ``reference_chunk``.
"""

from __future__ import annotations

from benchmark import corpus, weights_siglip
from benchmark.checks import embedding_gap
from benchmark.drivers.encode_stream import release, window  # noqa: F401


def program_config(config: dict):
    """The port's SigLIPConfig with the configuration file's sizes."""
    from clipx_torch.config import (SigLIPConfig, SigLIPTextConfig,
                                    SigLIPVisionConfig)

    keys = ("quick_gelu", "activation", "layernorm_eps", "center_crop",
            "logit_bias", "tokenizer")
    return SigLIPConfig(
        name=config["name"], vision=SigLIPVisionConfig(**config["vision"]),
        text=SigLIPTextConfig(**config["text"]),
        image_mean=tuple(config["image_mean"]),
        image_std=tuple(config["image_std"]),
        **{k: config[k] for k in keys})


def setup(run):
    from clipx_torch.runtime.encoder import Encoder

    p = run.traffic
    cfg = program_config(run.config)
    with run.stage("weights"):
        params = weights_siglip.make_params(run.config, run.seed, run.device)
    with run.stage("encoder"):
        enc = Encoder(cfg, params, device=run.device)
    del params
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


def reference_embeddings(run, quant: str = ""):
    """The reference's L2-normalised embeddings of the run's frame pool,
    (pool_batches, batch, E) on the host."""
    from benchmark.reference.siglip import encode_images

    p = run.traffic
    size = run.config["vision"]["image_size"]
    frames = corpus.frames(run.seed, p["pool_batches"] * p["batch"], size,
                           run.device)
    params = weights_siglip.make_params(run.config, run.seed, run.device)
    ref = encode_images(params, run.config, frames,
                        chunk=p.get("reference_chunk", 16),
                        quant=quant).cpu().numpy()
    return ref.reshape(p["pool_batches"], p["batch"], -1)


def check(run) -> dict:
    """The worst L2 distance between a returned embedding and the
    reference's f32 embedding of its frame."""
    ref = reference_embeddings(run)
    gap = max(embedding_gap(emb, ref[j]) for j, emb, _ in run.data["done"])
    return {"emb_gap": {"value": gap, "limit": run.limits["emb_gap"]}}
