"""Shared CLI plumbing for the port: flags, env names, encoder and index.

Counterpart of ``clipx/cli/common.py``. The flags, their environment
variables and the on-disk names are clipx's, so a command line (and a
``vectors.lmdb`` + ``images.index`` pair) works with either package. The
port adds ``--device {cuda,cpu}`` (default ``cuda``; no GPU and no
``--device cpu`` is an error). Flag values whose code paths are not ported
yet (``--corpus-dtype`` other than f32, ``--search-mode ivf``,
``--compute int8``, ``--preprocess device``) exit with a message saying so.
"""

from __future__ import annotations

import argparse
import os
import sys

from clipx_torch.runtime.device import DEVICES, resolve_device

# Same on-disk names as the reference (reference:build-index.py:22,109)
DEFAULT_DB_PATH = "vectors.lmdb"
DEFAULT_INDEX_PATH = "images.index"
DEFAULT_MAP_SIZE = 1024 * 1024 * 1024 * 20

FN_DB = b"fn_db"
SKIP_DB = b"skip_db"
IDX_DB = b"idx_db"

# corpus size from which the int8 scan + exact-rescore path wins
QUANT_AUTO_THRESHOLD = 100_000

# flag values accepted (clipx's choices) whose paths are not ported yet
_NOT_PORTED = {"corpus_dtype": ("bf16", "int8", "int4", "pq"),
               "search_mode": ("ivf",), "compute": ("int8",),
               "preprocess": ("device",)}


def add_model_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model",
                        default=os.environ.get("CLIPX_MODEL", "ViT-B/32"),
                        help="model preset (ViT-B/32, ViT-B/16, ViT-L/14, "
                             "ViT-L/14@336px, tiny-test)")
    parser.add_argument("--checkpoint",
                        default=os.environ.get("CLIPX_CHECKPOINT"),
                        help="converted .npz params or torch .pt state "
                             "dict; random init when omitted")
    parser.add_argument("--compute", choices=("bf16", "int8"),
                        default=os.environ.get("CLIPX_COMPUTE") or None,
                        help="encode arithmetic: bf16 (int8 W8A8 is not "
                             "ported yet)")
    parser.add_argument("--db", default=os.environ.get("CLIPX_DB",
                                                       DEFAULT_DB_PATH))
    parser.add_argument("--index", default=os.environ.get("CLIPX_INDEX",
                                                          DEFAULT_INDEX_PATH))
    parser.add_argument("--corpus-dtype",
                        choices=("f32", "bf16", "int8", "int4", "pq"),
                        default=os.environ.get("CLIPX_CORPUS_DTYPE", "f32"),
                        help="device storage dtype of the search corpus "
                             "(only f32 is ported yet)")
    parser.add_argument("--search-mode",
                        choices=("exact", "quant", "auto", "ivf"),
                        default=os.environ.get("CLIPX_SEARCH_MODE", "auto"),
                        help="exact: f32 scan; quant: int8 scan + exact "
                             "f32 rescore; auto: quant from 100k vectors "
                             "(ivf is not ported yet)")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where the model and the index run (default "
                             "cuda; cpu must be asked for)")


def check_ported(args) -> None:
    """Exit with a clear message for flag values not ported yet, and when
    CUDA is asked for with no GPU visible."""
    for flag, values in _NOT_PORTED.items():
        value = getattr(args, flag, None)
        if value in values:
            name = "--" + flag.replace("_", "-")
            raise SystemExit(f"error: {name} {value} is not yet ported to "
                             "clipx_torch (use the clipx package for it)")
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc}") from None


def apply_search_mode(index, mode: str):
    """Configure an index's scan mode per the --search-mode flag."""
    index.quantized = (mode == "quant" or
                       (mode == "auto"
                        and index.ntotal >= QUANT_AUTO_THRESHOLD))
    return index


def load_index(args):
    """Read ``images.index`` and place it on the flag-selected device,
    with --search-mode applied."""
    from clipx_torch.search.engine import read_index

    return apply_search_mode(read_index(args.index, device=args.device),
                             args.search_mode)


def make_encoder(args):
    from clipx_torch.runtime.encoder import Encoder

    enc = Encoder.create(args.model, checkpoint=args.checkpoint,
                         device=args.device)
    if args.checkpoint is None and args.model != "tiny-test":
        print("(no checkpoint given — using randomly initialized weights; "
              "pass --checkpoint or set $CLIPX_CHECKPOINT for real "
              "embeddings)")
    elif args.checkpoint and not enc.tokenizer.has_learned_merges:
        print(
            "WARNING: checkpoint loaded but the BPE merge table "
            "(bpe_simple_vocab_16e6.txt.gz) was not found — TEXT QUERIES "
            "WILL NOT MATCH THESE WEIGHTS. Point $CLIPX_BPE_PATH at the "
            "merge file (ships with OpenAI CLIP) or place it next to "
            "clipx_torch/text/tokenizer.py. Image-similarity ('i ID') "
            "queries are unaffected.",
            file=sys.stderr, flush=True)
    return enc
