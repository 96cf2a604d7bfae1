"""Search and embedding quality over a built index (the quality gate).

    python -m clipx_torch.tools.eval_quality --db vectors.lmdb \
        --index images.index [--photos DIR/ --model NAME] [--device cpu]

Counterpart of the root ``tools/eval_quality.py``, with the same flags
(plus ``--device``), the same stdout lines and the same ``--json`` keys.
Using the indexed corpus itself as queries (no labels needed), it reports:

- **self-retrieval**: every sampled vector must find its own id at rank 0
  with a score of ~1 (catches id/vector misalignment end to end);
- **mode agreement**: recall@k and top-1 agreement of quantized search
  (int8 + rescore), of each storage tier (bf16, int8, int4, pq) and of IVF
  (f32 at nprobe 100 and 32, the int8 probed scan, int8, int4 and residual
  pq storage) against the exact f32 ranking;
- **preprocess drift** (with ``--photos``): a sample of the source images
  re-encoded through the PIL-parity and cv2 host paths, each against its
  stored embedding (cosine), and, for a ViT tower, the ``--compute int8``
  encoder against the bf16 one on the same pixels.

With more than one device of ``--device``'s type visible (GPUs; the CPU
counts as one), it also prints clipx's ``sharded vs exact`` line (a
``ShardedVectorIndex`` over every visible device) and runs the IVF lines on
``ShardedIVFIndex``, which the IVF line names. Returns 0 when every
self-retrieval hit, 2 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from clipx_torch.runtime.device import DEVICES
from clipx_torch.utils.env import restoring

RESULTS = {}


def _record(key, **vals):
    RESULTS[key] = {k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in vals.items()}


def _recall(ref_ids, ids, k: int) -> float:
    return float(np.mean([len(set(ref_ids[i]) & set(ids[i])) / k
                          for i in range(len(ref_ids))]))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="eval_quality")
    ap.add_argument("--db", default="vectors.lmdb")
    ap.add_argument("--index", default="images.index")
    ap.add_argument("--photos", default=None,
                    help="re-encode a sample from this folder and compare "
                         "against stored embeddings (needs --model to "
                         "match the indexing run)")
    ap.add_argument("--model", default=os.environ.get("CLIPX_MODEL",
                                                      "ViT-B/32"))
    ap.add_argument("--checkpoint",
                    default=os.environ.get("CLIPX_CHECKPOINT"))
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--json", default=None,
                    help="also write every reported number to this "
                         "JSON file (quality artifacts)")
    ap.add_argument("--pq-modes", choices=("default", "both"),
                    default="default",
                    help="pq variants to evaluate: 'default' runs the "
                         "shipping config only (opq=trained, "
                         "residual=on); 'both' adds the baselines "
                         "(opq=fixed, residual=off); each extra variant "
                         "costs a full train+encode")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where the indexes and the encoders run (default "
                         "cuda; cpu must be asked for)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from clipx_torch.parallel.mesh import visible_devices
    from clipx_torch.parallel.mips import ShardedVectorIndex, shard_mesh
    from clipx_torch.search.engine import VectorIndex, read_index
    from clipx_torch.search.ivf import IVFIndex, ShardedIVFIndex

    dev = args.device
    index = read_index(args.index, device=dev)
    if index.ntotal == 0:
        print("index is empty")
        return 1
    n = index.ntotal
    rng = np.random.RandomState(0)
    sample = rng.choice(n, size=min(args.samples, n), replace=False)
    queries = np.stack([index.reconstruct(int(i)) for i in sample])
    RESULTS.clear()

    # self-retrieval
    D, I = index.search(queries, k=1)
    hits = int((I[:, 0] == sample).sum())
    score_ok = int((np.abs(D[:, 0] - 1.0) < 1e-2).sum())
    print(f"self-retrieval: {hits}/{len(sample)} rank-0 hits, "
          f"{score_ok}/{len(sample)} scores ~1.0")
    _record("self_retrieval", hits=hits, n=len(sample),
            scores_ok=score_ok)

    k = min(args.k, n)
    _, Ie = index.search(queries, k=k)
    vectors = index.vectors()

    def agreement(idx):
        _, ids = idx.search(queries, k=k)
        return _recall(Ie, ids, k), float(np.mean(Ie[:, 0] == ids[:, 0]))

    # quantized agreement
    recall, top1 = agreement(VectorIndex.from_vectors(
        vectors, quantized=True, device=dev))
    print(f"int8+rescore vs exact: recall@{k} {recall:.4f}, "
          f"top-1 agreement {top1:.4f}")
    _record("quant_int8_rescore", recall=recall, top1=top1, k=k)

    # bf16 storage (--corpus-dtype bf16, the capacity knob)
    recall, top1 = agreement(VectorIndex.from_vectors(
        vectors, quantized=True, device=dev, dtype="bf16"))
    print(f"bf16-corpus int8+rescore vs exact f32: recall@{k} "
          f"{recall:.4f}, top-1 agreement {top1:.4f}")
    _record("bf16_storage", recall=recall, top1=top1, k=k)

    # int8 storage: the codes are the corpus, the rescore dequantizes
    recall, top1 = agreement(VectorIndex.from_vectors(vectors, device=dev,
                                                      dtype="int8"))
    print(f"int8-storage vs exact f32: recall@{k} {recall:.4f}, "
          f"top-1 agreement {top1:.4f}")
    _record("int8_storage", recall=recall, top1=top1, k=k)

    # int4 storage: packed 4-bit codes, the ~10x-capacity tier
    if index.dim % 2 == 0:
        recall, top1 = agreement(VectorIndex.from_vectors(
            vectors, device=dev, dtype="int4"))
        print(f"int4-storage vs exact f32: recall@{k} {recall:.4f}, "
              f"top-1 agreement {top1:.4f}")
        _record("int4_storage", recall=recall, top1=top1, k=k)

    # pq storage: 4-bit product quantization, the deepest capacity rung
    if index.dim % 4 == 0:
        opq_modes = (("trained",) if args.pq_modes == "default"
                     else ("fixed", "trained"))
        for opq in opq_modes:
            with restoring(CLIPX_PQ_OPQ=opq):
                ipq = VectorIndex.from_vectors(vectors, device=dev,
                                               dtype="pq")
            recall, top1 = agreement(ipq)
            print(f"pq-storage (dsub={ipq._pq.dsub}, opq={opq}) vs "
                  f"exact f32: recall@{k} {recall:.4f}, "
                  f"top-1 agreement {top1:.4f}")
            _record(f"pq_storage_opq_{opq}", recall=recall, top1=top1, k=k,
                    dsub=ipq._pq.dsub)

    # more than one device: the corpus row-sharded over all of them
    devices = visible_devices(dev)
    ivf_cls, ivf_kw = IVFIndex, {}
    if len(devices) > 1:
        mesh = shard_mesh(devices)
        _, Is = ShardedVectorIndex(vectors, mesh).search(queries, k=k)
        print(f"sharded vs exact: recall@{k} {_recall(Ie, Is, k):.4f} "
              f"({len(devices)} devices)")
        ivf_cls, ivf_kw = ShardedIVFIndex, {"mesh": mesh}

    # IVF (--search-mode ivf): nprobe 100 probes everything and must
    # reproduce the exact ranking; nprobe 32 is the shipping default
    def ivf_recall(idx, nprobe=None):
        _, ids = idx.search(queries, k=k, nprobe=nprobe)
        return _recall(Ie, ids, k)

    def ivf(**kw):
        return ivf_cls.from_vectors(vectors, device=dev, **ivf_kw, **kw)

    ivf_f32 = ivf()
    r_full, r_def = ivf_recall(ivf_f32, 100), ivf_recall(ivf_f32)
    print(f"ivf vs exact ({ivf_cls.__name__}): recall@{k} {r_full:.4f} "
          f"at nprobe=100, {r_def:.4f} at nprobe=32")
    _record("ivf_f32", recall_nprobe100=r_full, recall_nprobe32=r_def, k=k)
    # the int8 probed scan, which ivf mode runs from 100k rows
    r_fullq = ivf_recall(ivf(quantized=True), 100)
    print(f"ivf-int8 vs exact: recall@{k} {r_fullq:.4f} at nprobe=100")
    r_fulls = ivf_recall(ivf(dtype="int8"), 100)
    print(f"ivf-int8-storage vs exact f32: recall@{k} {r_fulls:.4f} "
          f"at nprobe=100")
    _record("ivf_int8_storage", recall_nprobe100=r_fulls, k=k)
    if index.dim % 2 == 0:
        r_full4 = ivf_recall(ivf(dtype="int4"), 100)
        print(f"ivf-int4-storage vs exact f32: recall@{k} {r_full4:.4f} "
              f"at nprobe=100")
        _record("ivf_int4_storage", recall_nprobe100=r_full4, k=k)
    if index.dim % 4 == 0:
        res_modes = (("on",) if args.pq_modes == "default"
                     else ("off", "on"))
        for res in res_modes:
            with restoring(CLIPX_PQ_RESIDUAL=res):
                ivf_pq = ivf(dtype="pq")
            r_fullp, r_defp = ivf_recall(ivf_pq, 100), ivf_recall(ivf_pq)
            print(f"ivf-pq-storage (residual={res}) vs exact f32: "
                  f"recall@{k} {r_fullp:.4f} at nprobe=100, "
                  f"{r_defp:.4f} at nprobe=32")
            _record(f"ivf_pq_residual_{res}", recall_nprobe100=r_fullp,
                    recall_nprobe32=r_defp, k=k)

    if args.photos:
        _preprocess_drift(args, sample)
    if args.json:
        RESULTS["config"] = {"index": args.index, "ntotal": int(n),
                             "dim": int(index.dim), "k": int(k),
                             "samples": int(len(sample))}
        with open(args.json, "w") as f:
            json.dump(RESULTS, f, indent=1, sort_keys=True)
        print(f"(wrote {args.json})")
    return 0 if hits == len(sample) else 2


def _preprocess_drift(args, sample) -> None:
    """Up to 16 sampled images re-encoded from their files: the PIL-parity
    and cv2 host paths against the stored embeddings, and the int8
    encoder against the bf16 one on the PIL pixels (ViT towers only)."""
    from PIL import Image

    from clipx_torch.ops.preprocess import cv2_resize_crop, pil_resize_crop
    from clipx_torch.runtime.encoder import Encoder
    from clipx_torch.store.kv import open_env

    env = open_env(args.db)
    idx_db = env.open_db(b"idx_db")
    fn_db = env.open_db(b"fn_db")
    # pinned to bf16: with CLIPX_COMPUTE=int8 in the environment the gate
    # would otherwise compare the int8 encoder with itself
    enc = Encoder.create(args.model, checkpoint=args.checkpoint,
                         compute_quant="bf16", device=args.device)
    enc8 = None
    if getattr(enc.cfg.vision, "tower", "vit") == "vit":
        # --compute int8 drift on the SAME pixels: the W8A8 MLP alone
        enc8 = Encoder.create(args.model, checkpoint=args.checkpoint,
                              compute_quant="int8", device=args.device)
    cos_pil, cos_cv2, cos_int8 = [], [], []
    with env.begin() as txn:
        for i in sample[:16]:
            path = txn.get(str(int(i)).encode(), db=idx_db)
            if path is None:
                continue
            stored = np.frombuffer(txn.get(path, db=fn_db),
                                   dtype=np.float32)
            fname = path.decode()
            if not os.path.exists(fname):
                continue
            with Image.open(fname) as img:
                pil = pil_resize_crop(img, enc.image_size)
                rgb = np.asarray(img.convert("RGB"))
            cv = cv2_resize_crop(rgb, enc.image_size)
            e_pil = enc.encode_images(pil[None])[0]
            e_cv = enc.encode_images(cv[None])[0]
            cos_pil.append(float(stored @ e_pil))
            cos_cv2.append(float(stored @ e_cv))
            if enc8 is not None:
                e8 = enc8.encode_images(pil[None])[0]
                cos_int8.append(float(e_pil @ e8))
    env.close()
    if cos_pil:
        print(f"preprocess drift vs stored (cosine, n={len(cos_pil)}): "
              f"pil min {min(cos_pil):.4f} mean {np.mean(cos_pil):.4f}; "
              f"cv2 min {min(cos_cv2):.4f} mean {np.mean(cos_cv2):.4f}")
    if cos_int8:
        print(f"int8-compute drift vs bf16 (cosine, n={len(cos_int8)}): "
              f"min {min(cos_int8):.4f} mean {np.mean(cos_int8):.4f}")


if __name__ == "__main__":
    sys.exit(main())
