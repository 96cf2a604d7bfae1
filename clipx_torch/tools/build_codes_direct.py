"""Build a capacity-scale residual-IVFPQ deployment directly: codes file
+ ``.ivf`` cache (+ id map), no f32 sidecar ever written.

    python -m clipx_torch.tools.build_codes_direct DIR --rows 100000000 \
        [--dim 512] [--kind clustered|aniso] [--store ids|none] \
        [--json OUT] [--device cpu]

Counterpart of the root ``tools/build_codes_direct.py``, with its flags
(plus ``--device``, default ``cuda``), its passes and its ``--json`` stats.
Past ~24M rows the f32 sidecar is the artifact that does not fit (100M x
512 is 204 GB that query time never reads once codes exist). This tool
builds the codes-only deployment through the real artifact chain
(canonical residual encoding, v2 ``.ivf`` cache, self-integrity footer) by
streaming a chunk-keyed deterministic synthetic corpus three times instead
of storing it once:

  pass A  generate -> content hash + hierarchical cluster assignment
  pass B  generate -> per-segment sums (the coarse quantizer)
  pass C  generate -> residual OPQ-PQ encode -> stream into CodesWriter

Chunk-keyed generation (chunk c seeds ``SFC64((seed, c))``) makes every
pass, and any later evaluation, see the same rows bit for bit, in clipx's
tool as here. The coarse k-means runs on ``--device`` (the port's
``search/ivf.py``, seeded from numpy: its centroids are not clipx's, so the
two tools' deployments differ, and each package boots the other's). The
assignment, the sums and the OPQ-PQ training and encode are host numpy,
where the port's ``codes_io`` and ``pq`` keep them.

Cluster assignment is hierarchical: centroids are grouped by k-means into
sqrt(C) groups and each row scores the members of its top
``--refine-groups`` groups only (~20x cheaper than exact argmax over 4096
centroids). Agreement with exact argmax is measured on a sample and
recorded in the JSON; a mismatch only softens cluster coherence (recall),
never correctness, since the sums and centroids are computed from the
layout that ships.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from clipx_torch.runtime.device import DEVICES, full_f32, resolve_device

CHUNK = 1 << 17


class SynthCorpus:
    """Chunk-keyed deterministic synthetic corpus: row i is a pure
    function of (seed, i // CHUNK, i % CHUNK) — any pass, process, or
    platform regenerates identical f32 bytes. Exposes just enough of
    the ndarray protocol for streaming consumers."""

    def __init__(self, rows: int, dim: int, kind: str, seed: int):
        self.shape = (rows, dim)
        self.dtype = np.float32
        self.kind = kind
        self.seed = seed
        self._spec = (np.arange(1, dim + 1, dtype=np.float32) ** -0.75)
        if kind == "clustered":
            rng = np.random.Generator(np.random.SFC64((seed, 1 << 40)))
            c = rng.standard_normal((4096, dim), dtype=np.float32)
            c *= self._spec
            c /= np.linalg.norm(c, axis=1, keepdims=True)
            self.centers = c
        else:
            self.centers = None

    def chunk(self, c: int) -> np.ndarray:
        # SFC64 + in-place mixing, as clipx's tool (the same bytes): the
        # generation is the build's inner loop, three full passes
        rows, dim = self.shape
        n = min(CHUNK, rows - c * CHUNK)
        rng = np.random.Generator(np.random.SFC64((self.seed, c)))
        v = rng.standard_normal((n, dim), dtype=np.float32)
        v *= self._spec
        if self.centers is not None:
            a = rng.integers(0, len(self.centers), n)
            v *= np.float32(0.3)
            v += np.take(self.centers, a, axis=0)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return v

    def n_chunks(self) -> int:
        return -(-self.shape[0] // CHUNK)

    def rows_at(self, idx: np.ndarray) -> np.ndarray:
        """Arbitrary rows (regenerates each covering chunk once)."""
        idx = np.asarray(idx, np.int64)
        out = np.empty((len(idx), self.shape[1]), np.float32)
        order = np.argsort(idx, kind="stable")
        s = idx[order]
        pos = 0
        while pos < len(s):
            c = int(s[pos]) // CHUNK
            end = pos
            while end < len(s) and s[end] // CHUNK == c:
                end += 1
            rows = self.chunk(c)
            out[order[pos:end]] = rows[s[pos:end] - c * CHUNK]
            pos = end
        return out


def _hier_groups(cent: np.ndarray, n_groups: int, seed: int = 7):
    """K-means the C centroids into n_groups; returns (group centroids
    (G, D), member lists per group). Tiny problem — plain numpy."""
    rng = np.random.default_rng(seed)
    C = len(cent)
    g = cent[rng.choice(C, n_groups, replace=False)].copy()
    for _ in range(10):
        a = np.argmax(cent @ g.T, axis=1)
        for j in range(n_groups):
            m = a == j
            if m.any():
                v = cent[m].mean(axis=0)
                g[j] = v / max(np.linalg.norm(v), 1e-12)
    a = np.argmax(cent @ g.T, axis=1)
    members = [np.flatnonzero(a == j) for j in range(n_groups)]
    # empty groups keep a dummy member so indexing stays simple
    members = [m if len(m) else np.array([0]) for m in members]
    return g, members


class HierAssigner:
    """Approximate nearest-centroid assignment. Each row picks its
    top-1 GROUP (a (n, G) GEMM), then exact-scores only the candidate
    centroids of that group — its own members plus the members of its
    ``refine-1`` nearest neighbor groups (precomputed adjacency). All
    work is dense GEMMs over per-group row batches: ~(G + refine*C/G)
    dots per row instead of C, with no giant gather transients."""

    def __init__(self, cent: np.ndarray, refine: int = 2):
        G = max(1, int(round(np.sqrt(len(cent)))))
        self.cent = cent
        refine = max(1, min(refine, G))
        self.g, members = _hier_groups(cent, G)
        # neighbor groups by group-centroid similarity (incl. self)
        gsim = self.g @ self.g.T
        nbr = np.argsort(-gsim, axis=1)[:, :refine]         # (G, r)
        self.cand = [np.unique(np.concatenate([members[j]
                                               for j in nbr[i]]))
                     for i in range(G)]

    def assign(self, rows: np.ndarray) -> np.ndarray:
        top = np.argmax(rows @ self.g.T, axis=1)            # (n,)
        out = np.empty(len(rows), np.int32)
        for i in np.unique(top):
            m = np.flatnonzero(top == i)
            cand = self.cand[i]
            cs = rows[m] @ self.cent[cand].T                # GEMM
            out[m] = cand[np.argmax(cs, axis=1)]
        return out

    def exact(self, rows: np.ndarray) -> np.ndarray:
        return np.argmax(rows @ self.cent.T, axis=1).astype(np.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="build_codes_direct")
    ap.add_argument("outdir")
    ap.add_argument("--rows", type=int, required=True)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--kind", choices=("clustered", "aniso"),
                    default="clustered")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--refine-groups", type=int, default=12,
                    help="neighbor groups scored per row in the "
                         "hierarchical assignment; agreement vs exact "
                         "argmax is measured and recorded")
    ap.add_argument("--dsub", type=int, choices=(2, 4), default=None,
                    help="pq subspace width (default: $CLIPX_PQ_DSUB "
                         "or 2; the 100-200M capacity tier uses 4 = "
                         "1 bit/dim)")
    ap.add_argument("--store", choices=("ids", "none"), default="ids")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where the coarse k-means runs (default cuda; cpu "
                         "must be asked for); the assignment, sums and pq "
                         "encode are host work")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    if args.dsub is not None:
        from clipx_torch.utils.env import restoring

        with restoring(CLIPX_PQ_DSUB=str(args.dsub)):
            return _run(args)
    return _run(args)


def _run(args) -> int:
    from clipx_torch.search import codes_io, ivf
    from clipx_torch.search import pq as pq_lib
    from clipx_torch.search.engine import _SEG_W, corpus_rotation

    t00 = time.time()
    os.makedirs(args.outdir, exist_ok=True)
    index_path = os.path.join(args.outdir, "images.index")
    corpus = SynthCorpus(args.rows, args.dim, args.kind, args.seed)
    n, dim = corpus.shape
    stats = {"rows": n, "dim": dim, "kind": args.kind,
             "seed": args.seed, "chunk": CHUNK}

    def log(msg):
        print(f"[{time.time() - t00:7.0f}s] {msg}", flush=True)

    # ---- train the coarse k-means on chunk samples (chunks are iid
    # draws from the same mixture, so chunk-level sampling is unbiased)
    t0 = time.time()
    need = ivf._TRAIN_CAP
    sample_chunks, got = [], 0
    rng = np.random.default_rng((args.seed, 1 << 41))
    for c in rng.permutation(corpus.n_chunks())[:corpus.n_chunks()]:
        sample_chunks.append(corpus.chunk(int(c)))
        got += len(sample_chunks[-1])
        if got >= need:
            break
    train_x = np.concatenate(sample_chunks)[:need]
    del sample_chunks
    C = min(ivf._num_clusters(n), n)
    # the port's k-means (numpy-seeded init, so not clipx's centroids: the
    # two packages' deployments differ, and each boots the other's)
    with torch.inference_mode(), full_f32(args.device):
        cent = ivf._kmeans(torch.from_numpy(train_x).to(args.device), C, 8,
                           np.random.default_rng(args.seed)).cpu().numpy()
    stats["n_clusters"] = int(C)
    stats["train_s"] = round(time.time() - t0, 1)
    log(f"k-means trained: C={C} on {len(train_x)} sampled rows "
        f"({stats['train_s']}s)")

    # ---- pass A: content hash + hierarchical assignment
    t0 = time.time()
    assigner = HierAssigner(cent, refine=args.refine_groups)
    agree = float(np.mean(
        assigner.assign(train_x[:8192]) == assigner.exact(train_x[:8192])))
    stats["assign_agreement"] = round(agree, 4)
    log(f"hierarchical assignment agreement vs exact: {agree:.3f} "
        f"(refine={args.refine_groups})")
    del train_x
    h = hashlib.blake2b(digest_size=16)
    assign = np.empty(n, np.int32)
    done = 0
    for c in range(corpus.n_chunks()):
        rows = corpus.chunk(c)
        h.update(rows.tobytes())
        assign[done: done + len(rows)] = assigner.assign(rows)
        done += len(rows)
        if c % 64 == 0:
            log(f"  pass A {done:,}/{n:,}")
    content_hash = h.digest()
    stats["pass_a_s"] = round(time.time() - t0, 1)
    log(f"pass A done: content_hash={content_hash.hex()} "
        f"({stats['pass_a_s']}s)")

    # ---- layout + seg map
    t0 = time.time()
    layout = ivf.cluster_layout(assign)
    del assign
    live = layout >= 0
    pos = np.flatnonzero(live)
    seg_of_ext = np.empty(n, np.int64)
    seg_of_ext[layout[pos]] = pos // _SEG_W
    segs = len(layout) // _SEG_W
    counts = live.reshape(segs, _SEG_W).sum(axis=1).astype(np.float32)
    stats["segments"] = int(segs)
    stats["layout_s"] = round(time.time() - t0, 1)
    log(f"layout built: {segs:,} segments ({stats['layout_s']}s)")

    # ---- pass B: per-segment sums (sorted-reduceat per chunk: the
    # np.add.at scatter is ~10x slower at this scale)
    t0 = time.time()
    sums = np.zeros((segs, dim), np.float32)
    done = 0
    for c in range(corpus.n_chunks()):
        rows = corpus.chunk(c)
        sid = seg_of_ext[done: done + len(rows)]
        order = np.argsort(sid, kind="stable")
        ssid = sid[order]
        cut = np.flatnonzero(np.diff(ssid)) + 1
        starts = np.concatenate([[0], cut])
        part = np.add.reduceat(np.take(rows, order, axis=0), starts,
                               axis=0)
        sums[ssid[starts]] += part
        done += len(rows)
        if c % 64 == 0:
            log(f"  pass B {done:,}/{n:,}")
    cent_unrot = sums / np.maximum(counts[:, None], 1.0)
    stats["pass_b_s"] = round(time.time() - t0, 1)
    log(f"pass B done ({stats['pass_b_s']}s)")

    # ---- residual OPQ-PQ training on chunk-sampled residuals
    t0 = time.time()
    rot0 = corpus_rotation(dim)
    got, res_parts = 0, []
    for c in rng.permutation(corpus.n_chunks())[:corpus.n_chunks()]:
        rows = corpus.chunk(int(c))
        sid = seg_of_ext[int(c) * CHUNK: int(c) * CHUNK + len(rows)]
        rows -= np.take(cent_unrot, sid, axis=0)
        res_parts.append(rows)
        got += len(rows)
        if got >= pq_lib._PQ_TRAIN_SAMPLE:
            break
    res_sample = np.concatenate(res_parts)[: pq_lib._PQ_TRAIN_SAMPLE]
    del res_parts
    rot, cb = pq_lib.train_opq(res_sample, rot0)
    del res_sample
    stats["pq_train_s"] = round(time.time() - t0, 1)
    stats["dsub"] = int(cb.dsub)
    log(f"residual OPQ-PQ trained: m={cb.m} dsub={cb.dsub} "
        f"({stats['pq_train_s']}s)")

    # ---- pass C: encode + stream the codes file
    t0 = time.time()
    writer = codes_io.CodesWriter(
        codes_io.codes_path(index_path), tier="pq", ntotal=n, dim=dim,
        code_dim=cb.m // 2, rotated=rot is not None,
        fp_sample=None, dsub=cb.dsub,
        opq=rot is not None and pq_lib.opq_mode() == "trained",
        residual=True, layout_digest=ivf.layout_digest(layout))
    done = 0
    for c in range(corpus.n_chunks()):
        rows = corpus.chunk(c)
        sid = seg_of_ext[done: done + len(rows)]
        rows -= np.take(cent_unrot, sid, axis=0)
        codes = cb.encode(rows, rot=rot)
        writer.write_codes(codes)
        done += len(rows)
        if c % 64 == 0:
            log(f"  pass C {done:,}/{n:,}")
    writer.set_centroids(cb.centroids)
    if writer.opq:
        writer.set_rotation(rot)
    writer.set_content_hash(content_hash)
    writer.close()
    stats["pass_c_s"] = round(time.time() - t0, 1)
    stats["codes_gib"] = round(os.path.getsize(
        codes_io.codes_path(index_path)) / 2**30, 3)
    log(f"pass C done: {stats['codes_gib']} GiB codes "
        f"({stats['pass_c_s']}s)")

    # ---- v2 .ivf cache (fp = the content hash the codes file records)
    t0 = time.time()
    tmp = index_path + ".ivf.tmp"
    np.savez(tmp, version=ivf._CACHE_VERSION,
             fp=np.frombuffer(content_hash, dtype=np.uint8),
             layout=layout.astype(np.int32), sums=sums)
    os.replace(tmp + ".npz", index_path + ".ivf")
    stats["cache_gib"] = round(os.path.getsize(index_path + ".ivf")
                               / 2**30, 3)
    stats["cache_s"] = round(time.time() - t0, 1)
    log(f".ivf cache written: {stats['cache_gib']} GiB")
    del sums, cent_unrot, layout, seg_of_ext, live, pos

    # ---- id -> path map (what serve/query resolve results through)
    if args.store == "ids":
        t0 = time.time()
        from clipx_torch.store.kv import open_env

        env = open_env(os.path.join(args.outdir, "vectors.lmdb"),
                       map_size=1 << 40, max_dbs=4)
        idx_db = env.open_db(b"idx_db")
        digits = len(str(n))
        done = 0
        while done < n:
            m = min(1 << 20, n - done)
            with env.begin(db=idx_db, write=True) as txn:
                for j in range(done, done + m):
                    txn.put(str(j).encode(),
                            f"/synth/img{j:0{digits}d}.jpg".encode())
            done += m
            log(f"  ids {done:,}/{n:,}")
        env.close()
        stats["store_s"] = round(time.time() - t0, 1)

    stats["total_s"] = round(time.time() - t00, 1)
    stats["peak_rss_gib"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20), 2)
    print(json.dumps(stats))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
