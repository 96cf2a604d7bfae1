"""Build a capacity-scale index from synthetic vectors through the real
artifacts: the sidecar through the streaming ``IndexWriter``, the id map
(and optionally the stored vectors) through the store.

    python -m clipx_torch.tools.make_synth_index DIR --rows 24000000 \\
        [--dim 512] [--store ids|full|none] [--kind clustered|aniso]

Counterpart of the root ``tools/make_synth_index.py``, with its flags, its
seeded generator and its stdout: the same ``--seed`` writes the same
sidecar bytes and the same id map as clipx's tool. Writes DIR/images.index
(+ DIR/vectors.lmdb unless ``--store none``). Vectors are unit-norm with a
CLIP-like power-law spectrum; 'clustered' adds 4096 cluster centers so IVF
and pq behave as they do on embeddings. Host work only (numpy and the
store), chunked: host RAM stays one chunk whatever ``--rows``. Paths are
synthetic ("/synth/img<i>.jpg", fixed width) in byte-sorted order, so id i
maps to row i as in a real build.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

CHUNK = 1 << 17


def gen_chunk(rng: np.random.Generator, n: int, dim: int, kind: str,
              cents: np.ndarray | None) -> np.ndarray:
    spec = (np.arange(1, dim + 1, dtype=np.float32) ** -0.75)
    v = rng.standard_normal((n, dim), dtype=np.float32) * spec
    if kind == "clustered":
        a = rng.integers(0, len(cents), n)
        v = cents[a] + 0.3 * v
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="make_synth_index")
    ap.add_argument("outdir")
    ap.add_argument("--rows", type=int, required=True)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--kind", choices=("clustered", "aniso"),
                    default="clustered")
    ap.add_argument("--store", choices=("ids", "full", "none"),
                    default="ids",
                    help="'ids' writes the idx_db id->path map (what "
                         "serve/query need to resolve results); 'full' "
                         "also stores every vector in fn_db (doubles "
                         "disk; enables /similar at capacity scale); "
                         "'none' writes the sidecar only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from clipx_torch.search.engine import IndexWriter

    os.makedirs(args.outdir, exist_ok=True)
    index_path = os.path.join(args.outdir, "images.index")
    rng = np.random.default_rng(args.seed)
    cents = None
    if args.kind == "clustered":
        spec = (np.arange(1, args.dim + 1, dtype=np.float32) ** -0.75)
        cents = rng.standard_normal((4096, args.dim),
                                    dtype=np.float32) * spec
        cents /= np.linalg.norm(cents, axis=1, keepdims=True)

    env = fn_db = idx_db = None
    if args.store != "none":
        from clipx_torch.store.kv import open_env

        env = open_env(os.path.join(args.outdir, "vectors.lmdb"),
                       map_size=1 << 40, max_dbs=4)
        idx_db = env.open_db(b"idx_db")
        if args.store == "full":
            fn_db = env.open_db(b"fn_db")

    # path width fixed so byte order == numeric order (id i = row i)
    digits = len(str(args.rows))
    t0 = time.time()
    writer = IndexWriter(index_path, args.rows, args.dim)
    done = 0
    while done < args.rows:
        n = min(CHUNK, args.rows - done)
        v = gen_chunk(rng, n, args.dim, args.kind, cents)
        writer.write(v)
        if env is not None:
            with env.begin(db=idx_db, write=True) as txn:
                for j in range(n):
                    i = done + j
                    txn.put(str(i).encode(),
                            f"/synth/img{i:0{digits}d}.jpg".encode())
            if fn_db is not None:
                with env.begin(db=fn_db, write=True) as txn:
                    for j in range(n):
                        i = done + j
                        txn.put(f"/synth/img{i:0{digits}d}.jpg".encode(),
                                v[j].tobytes())
        done += n
        if done % (1 << 21) < CHUNK:
            rate = done / max(time.time() - t0, 1e-9)
            print(f"  {done:,}/{args.rows:,} rows "
                  f"({rate / 1e6:.2f} M rows/s)", flush=True)
    writer.close()
    if env is not None:
        env.close()
    dt = time.time() - t0
    size = os.path.getsize(index_path)
    print(f"wrote {args.rows:,} x {args.dim} sidecar "
          f"({size / 2**30:.1f} GiB) + store={args.store} "
          f"in {dt:.0f}s; content_hash={writer.content_hash.hex()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
