"""Shared CLI plumbing for the port: flags, env names, encoder and index.

Counterpart of ``clipx/cli/common.py``. The flags, their environment
variables and the on-disk names are clipx's, so a command line (and a
``vectors.lmdb`` + ``images.index`` + ``images.index.codes`` set) works with
either package. The port adds ``--device {cuda,cpu}`` (default ``cuda``; no
GPU and no ``--device cpu`` is an error). ``--search-mode ivf`` builds (or
loads through ``<index>.ivf``) the IVF index of ``search/ivf.py``; the
indexer's ``--preprocess device`` decodes to a square canvas that the
Encoder resamples on the device. ``--sharded`` spreads the index (and the
indexer's encode) over the visible devices of ``--device``'s type: every
GPU, or one CPU shard (``parallel/``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import torch

from clipx_torch.parallel.mesh import visible_devices
from clipx_torch.runtime.device import DEVICES, resolve_device
from clipx_torch.search.engine import DTYPES

# Same on-disk names as the reference (reference:build-index.py:22,109)
DEFAULT_DB_PATH = "vectors.lmdb"
DEFAULT_INDEX_PATH = "images.index"
DEFAULT_MAP_SIZE = 1024 * 1024 * 1024 * 20

FN_DB = b"fn_db"
SKIP_DB = b"skip_db"
IDX_DB = b"idx_db"

# corpus size from which the int8 scan + exact-rescore path wins
QUANT_AUTO_THRESHOLD = 100_000

def add_model_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model",
                        default=os.environ.get("CLIPX_MODEL", "ViT-B/32"),
                        help="model preset (ViT-B/32, ViT-B/16, ViT-L/14, "
                             "ViT-L/14@336px, SigLIP-so400m/14@384, RN50, "
                             "RN101, RN50x4, RN50x16, RN50x64, tiny-test, "
                             "tiny-rn-test)")
    parser.add_argument("--checkpoint",
                        default=os.environ.get("CLIPX_CHECKPOINT"),
                        help="converted .npz params or torch .pt state "
                             "dict; random init when omitted")
    parser.add_argument("--compute", choices=("bf16", "int8"),
                        default=os.environ.get("CLIPX_COMPUTE") or None,
                        help="encode arithmetic: bf16 (default) or int8 "
                             "W8A8 MLP GEMMs on the ViT image tower (the "
                             "ResNet towers refuse it) "
                             "(clipx_torch/models/quant.py; the fused "
                             "kernel under CLIPX_FUSED_MLP_INT8=on). Text "
                             "encode stays bf16 either way")
    parser.add_argument("--db", default=os.environ.get("CLIPX_DB",
                                                       DEFAULT_DB_PATH))
    parser.add_argument("--index", default=os.environ.get("CLIPX_INDEX",
                                                          DEFAULT_INDEX_PATH))
    parser.add_argument("--corpus-dtype",
                        choices=DTYPES,
                        default=os.environ.get("CLIPX_CORPUS_DTYPE", "f32"),
                        help="device storage dtype of the search corpus: "
                             "f32; bf16 (half the bytes, f32 scores); "
                             "int8 / int4 (per-row codes of the rotated, "
                             "centred rows ARE the corpus: 1 / 0.5 B/dim, "
                             "quantized scan, dequantized f32 rescore); pq "
                             "(4-bit product quantization, 2 or 1 bit/dim "
                             "per $CLIPX_PQ_DSUB, scanned by the PQ "
                             "kernel). Coded tiers persist "
                             "<index>.codes. The sidecar stays f32")
    parser.add_argument("--search-mode",
                        choices=("exact", "quant", "auto", "ivf"),
                        default=os.environ.get("CLIPX_SEARCH_MODE", "auto"),
                        help="exact: full scan; quant: int8 scan + exact "
                             "rescore; auto: quant from 100k vectors (coded "
                             "tiers always scan quantized); ivf: clustered "
                             "search where the REPL's 'p' knob (nprobe) "
                             "trades recall for scan fraction "
                             "(clipx_torch/search/ivf.py)")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where the model and the index run (default "
                             "cuda; cpu must be asked for)")


def add_sharded_flag(parser: argparse.ArgumentParser, what: str) -> None:
    """clipx's --sharded flag (``sharded_devices`` reads it)."""
    parser.add_argument("--sharded", choices=("auto", "on", "off"),
                        default=os.environ.get("CLIPX_SHARDED", "auto"),
                        help=f"{what} over all visible devices of "
                             "--device's type (auto: only when more than "
                             "one is visible, so never on the CPU; on: "
                             "every visible GPU, or one CPU shard)")


def check_device(args) -> None:
    """Exit with a clear message when CUDA is asked for and no GPU is
    visible."""
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc}") from None


def sharded_devices(args) -> Optional[List[torch.device]]:
    """The devices ``--sharded`` spreads over, or None for one device:
    ``on`` takes every visible device of ``--device``'s type (every GPU, or
    the one CPU), ``auto`` the same when there is more than one."""
    mode = getattr(args, "sharded", "off")
    if mode == "off":
        return None
    devices = visible_devices(getattr(args, "device", None) or "cuda")
    return devices if mode == "on" or len(devices) > 1 else None


def search_mesh(args):
    """The ``"shard"`` mesh of a sharded index per --sharded, or None."""
    from clipx_torch.parallel.mips import shard_mesh

    devices = sharded_devices(args)
    return None if devices is None else shard_mesh(devices)


def encode_mesh(args):
    """The ``"dp"`` mesh of the indexer's data-parallel encode per
    --sharded, or None for a single-device encode."""
    from clipx_torch.parallel.mesh import make_mesh

    devices = sharded_devices(args)
    return None if devices is None else make_mesh({"dp": len(devices)},
                                                  devices)


def corpus_dtype(args) -> str:
    """--corpus-dtype / $CLIPX_CORPUS_DTYPE: the storage tier's name."""
    name = getattr(args, "corpus_dtype",
                   os.environ.get("CLIPX_CORPUS_DTYPE", "f32"))
    if name not in DTYPES:
        raise SystemExit(f"unknown corpus dtype {name!r} "
                         f"(f32, bf16, int8, int4 or pq)")
    return name


def apply_search_mode(index, mode: str):
    """Configure an index's scan mode per the --search-mode flag. Coded
    storage keeps its quantized scan: the codes are the corpus."""
    if index.coded_storage:
        return index
    if mode == "ivf":
        # IVF quantizes its probed scan past the same threshold
        index.quantized = index.ntotal >= QUANT_AUTO_THRESHOLD
    else:
        index.quantized = (mode == "quant" or
                           (mode == "auto"
                            and index.ntotal >= QUANT_AUTO_THRESHOLD))
    return index


def load_index(args):
    """Load the vector index per the flags on the flag-selected device,
    with --search-mode applied. Coded tiers go through ``<index>.codes``
    (``search/codes_io.py``): a fresh codes file loads directly, a missing
    or stale one is rebuilt from the memmapped f32 sidecar and persisted
    for the next start."""
    idx = load_coded_index(args)
    if idx is not None:
        return idx
    from clipx_torch.search.engine import read_index_vectors

    return build_index_from_vectors(read_index_vectors(args.index), args)


def load_coded_index(args):
    """The codes-file load path; None -> the caller uses the f32 path
    (uncoded tier, CLIPX_CODES=off, or an unreadable sidecar). A fresh
    codes file loads directly. With the f32 sidecar absent, the codes file
    stands alone (codes-only boot, see ``_load_codes_only``). Otherwise,
    flat tiers stream-encode the codes from the memmapped sidecar, write
    them and load them back; IVF builds through ``IVFIndex.from_vectors``
    and writes the install's own flat-order encode (residual pq codes depend
    on the layout), so nothing is encoded twice."""
    from clipx_torch.search import codes_io
    from clipx_torch.search.engine import (content_hash, corpus_rotation,
                                           read_index_vectors,
                                           rotation_enabled)

    tier = codes_io.tier_of(corpus_dtype(args))
    mode = codes_io.codes_mode()
    if tier is None or mode == "off":
        return None
    if not os.path.exists(args.index):
        if (mode == "on"
                and os.path.exists(codes_io.codes_path(args.index))):
            return _load_codes_only(args, tier)
        return None
    if mode == "on":
        payload = codes_io.load_codes(args.index, tier,
                                      rotated=rotation_enabled())
        if payload is not None:
            idx = build_index_from_codes(payload, args)
            if idx is not None:
                print(f"(loaded {payload['ntotal']} {tier} rows from "
                      f"{codes_io.codes_path(args.index)})",
                      file=sys.stderr, flush=True)
                return idx
    if getattr(args, "search_mode", "auto") == "ivf":
        try:
            vectors = read_index_vectors(args.index, mmap=True)
        except (OSError, ValueError):
            return None
        # the sidecar's fingerprint at memmap-open: a sidecar replaced
        # during the build must not get old-row codes stamped as fresh
        fp_at_open = codes_io.sidecar_sample_fp(args.index)
        idx = build_index_from_vectors(vectors, args, stash_codes=True)
        pending = idx._pending_codes_payload
        if pending is not None:
            try:
                codes_io.write_payload_file(
                    args.index, pending, tier=tier,
                    content_hash=content_hash(vectors),
                    fp_sample=fp_at_open)
            except (OSError, ValueError):
                pass  # unwritable dir / replaced sidecar: no codes file
            idx._pending_codes_payload = None
        return idx
    try:
        vectors = read_index_vectors(args.index, mmap=True)
        fp_at_open = codes_io.sidecar_sample_fp(args.index)
        codes_io.write_codes_file(
            args.index, vectors, tier,
            rot=corpus_rotation(vectors.shape[1]),
            content_hash=codes_io.sidecar_full_hash(args.index),
            fp_sample=fp_at_open)
    except (OSError, ValueError):
        return None  # unwritable dir / corrupt or replaced sidecar
    payload = codes_io.load_codes(args.index, tier,
                                  rotated=rotation_enabled())
    if payload is None:
        return None
    return build_index_from_codes(payload, args)


def _load_codes_only(args, tier: str):
    """Codes-only boot: ``<index>.codes`` exists but the f32 sidecar does
    not. The codes file verifies against its own integrity footer and
    becomes the source of truth. Lost without the sidecar: staleness
    detection, re-encoding to other tiers, incremental reload; every
    mismatch is therefore a hard, explained error."""
    from clipx_torch.search import codes_io
    from clipx_torch.search.engine import rotation_enabled

    cpath = codes_io.codes_path(args.index)
    payload = codes_io.load_codes(args.index, tier,
                                  rotated=rotation_enabled(),
                                  orphan=True)
    if payload is None:
        raise SystemExit(
            f"{cpath} failed to load for --corpus-dtype {tier} and the "
            f"f32 sidecar {args.index} is absent, so it cannot be "
            "rebuilt. Causes: integrity-footer mismatch (corrupt "
            "file), a different tier/rotation setting than the file "
            "was built with, or a truncated file. Restore the f32 "
            "sidecar or rebuild the codes file.")
    idx = build_index_from_codes(payload, args, orphan=True)
    print(f"(codes-only boot: loaded {payload['ntotal']} {tier} rows "
          f"from {cpath}; f32 sidecar absent — staleness checks and "
          "incremental reload unavailable)", file=sys.stderr,
          flush=True)
    return idx


def build_index_from_codes(payload, args, orphan: bool = False):
    """Place a loaded codes payload as the flag-selected index (flat or IVF)
    on ``args.device``. None when the caller's f32 path must rebuild: flat
    mode with residual pq codes (IVF-only), IVF with non-residual pq codes
    while residual encoding is on, or IVF without a matching v2 ``.ivf``
    cache. With ``orphan`` (codes-only boot, no sidecar to rebuild from)
    each of these is a hard error naming the fix, except the residual
    upgrade, which keeps the file's encoding with a warning. The index
    keeps the payload's corpus content hash as ``_boot_content_hash``:
    the HTTP service's incremental-reload fingerprint on a codes boot."""
    search_mode = getattr(args, "search_mode", "auto")
    device = getattr(args, "device", None)
    mesh = search_mesh(args) if payload["ntotal"] > 0 else None
    if payload.get("residual") and search_mode != "ivf":
        # residual-pq codes only score inside the IVF probe (they need the
        # segment coarse term)
        if orphan:
            raise SystemExit(
                "this codes file holds RESIDUAL pq codes, which only "
                "score under --search-mode ivf, and the f32 sidecar is "
                "absent so they cannot be re-encoded flat. Pass "
                "--search-mode ivf (the file's .ivf cache must be "
                "present too).")
        return None
    if (payload["tier"] == "pq" and not payload.get("residual")
            and search_mode == "ivf"):
        from clipx_torch.search.pq import pq_residual_enabled

        if pq_residual_enabled():
            # a flat-built codes file must not downgrade an IVF deployment
            # to global-codebook encoding: rebuild once as residual (opt
            # out with CLIPX_PQ_RESIDUAL=off)
            if orphan:
                print("WARNING: codes-only boot with a NON-residual pq "
                      "file under --search-mode ivf — residual "
                      "re-encoding needs the absent f32 sidecar, so "
                      "this deployment keeps global-codebook encoding "
                      "(measured -0.07..-0.17 recall@50 vs residual).",
                      file=sys.stderr, flush=True)
            else:
                return None
    if search_mode == "ivf":
        from clipx_torch.search.ivf import IVFIndex, ShardedIVFIndex

        index = getattr(args, "index", DEFAULT_INDEX_PATH)
        cls, kw = ((IVFIndex, {}) if mesh is None
                   else (ShardedIVFIndex, {"mesh": mesh}))
        idx = cls.from_codes(
            payload, index + ".ivf",
            quantized=payload["ntotal"] >= QUANT_AUTO_THRESHOLD,
            device=device, **kw)
        if idx is None and orphan:
            raise SystemExit(
                "codes-only IVF boot needs the v2 .ivf layout cache "
                f"({index}.ivf) "
                "matching this codes file (same corpus content hash"
                + (", same layout digest for residual codes"
                   if payload.get("residual") else "")
                + "); it is missing or stale, and rebuilding it needs "
                "the absent f32 sidecar. Deploy the .ivf cache "
                "alongside the codes file.")
    elif mesh is not None:
        from clipx_torch.parallel.mips import ShardedVectorIndex

        idx = ShardedVectorIndex.from_codes(payload, mesh)
    else:
        from clipx_torch.search.engine import VectorIndex

        idx = VectorIndex.from_codes(payload, device=device)
    if idx is not None:
        idx._boot_content_hash = payload.get("content_hash")
    return idx


def build_index_from_vectors(vectors, args, stash_codes: bool = False):
    """Place host vectors as the flag-selected index (flat, or IVF under
    --search-mode ivf; sharded under --sharded) of the flag-selected tier on
    ``args.device``, with --search-mode applied. ``stash_codes``: see
    ``IVFIndex.from_vectors``."""
    from clipx_torch.search.engine import VectorIndex

    search_mode = getattr(args, "search_mode", "auto")
    mesh = search_mesh(args) if vectors.shape[0] > 0 else None
    if search_mode == "ivf":
        from clipx_torch.search.ivf import IVFIndex, ShardedIVFIndex

        cls, kw = ((IVFIndex, {}) if mesh is None
                   else (ShardedIVFIndex, {"mesh": mesh}))
        return cls.from_vectors(
            vectors,
            quantized=vectors.shape[0] >= QUANT_AUTO_THRESHOLD,
            dtype=corpus_dtype(args),
            device=getattr(args, "device", None),
            cache_path=getattr(args, "index", DEFAULT_INDEX_PATH) + ".ivf",
            stash_codes=stash_codes, **kw)
    if mesh is not None:
        from clipx_torch.parallel.mips import ShardedVectorIndex

        sharded = ShardedVectorIndex(vectors, mesh, dtype=corpus_dtype(args))
        # --search-mode applies to both: the int8 scan must not disappear
        # when the corpus is sharded
        return apply_search_mode(sharded, search_mode)
    idx = VectorIndex(vectors.shape[1], device=getattr(args, "device", None),
                      dtype=corpus_dtype(args))
    if vectors.shape[0]:
        idx.add(vectors)
    return apply_search_mode(idx, search_mode)


def make_encoder(args, mesh=None):
    """The flag-selected Encoder on ``args.device``, or data-parallel over
    ``mesh`` (``encode_mesh``)."""
    from clipx_torch.runtime.encoder import Encoder

    enc = Encoder.create(args.model, checkpoint=args.checkpoint,
                         device=args.device, mesh=mesh,
                         compute_quant=getattr(args, "compute", None))
    if args.checkpoint is None and args.model != "tiny-test":
        print("(no checkpoint given — using randomly initialized weights; "
              "pass --checkpoint or set $CLIPX_CHECKPOINT for real "
              "embeddings)")
    elif (args.checkpoint and enc.tokenizer is not None
          and not enc.tokenizer.has_learned_merges):
        print(
            "WARNING: checkpoint loaded but the BPE merge table "
            "(bpe_simple_vocab_16e6.txt.gz) was not found — TEXT QUERIES "
            "WILL NOT MATCH THESE WEIGHTS. Point $CLIPX_BPE_PATH at the "
            "merge file (ships with OpenAI CLIP) or place it next to "
            "clipx_torch/text/tokenizer.py. Image-similarity ('i ID') "
            "queries are unaffected.",
            file=sys.stderr, flush=True)
    return enc
