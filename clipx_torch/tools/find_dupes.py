"""Near-duplicate photo groups from a built index.

    python -m clipx_torch.tools.find_dupes --db vectors.lmdb \\
        --index images.index --threshold 0.96 [--device cpu]

Counterpart of the root ``tools/find_dupes.py``, with its flags (plus
``--device``, default ``cuda``) and its output: a batched self-search over
the stored embeddings with the engine the REPL uses (exact search on the
device), then union-find over every pair scoring >= --threshold. One group
per block, best-connected member first, so ``xargs rm`` on the tail lines
of each block is a usable dedupe. Burst shots and re-exports of one photo
sit at cosine 0.96+ for CLIP embeddings; exact re-encodes at ~1.0.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from clipx_torch.runtime.device import DEVICES


def _find(parent: np.ndarray, i: int) -> int:
    while parent[i] != i:
        parent[i] = parent[parent[i]]  # path halving
        i = parent[i]
    return i


def dupe_groups(vectors: np.ndarray, threshold: float, k: int = 16,
                batch: int = 256, device=None):
    """Union-find over self-search pairs >= threshold. Returns a list of
    (group_row_ids, mean_pair_score) sorted largest-group first. ``k``
    bounds neighbours per row; a clique of near-dupes larger than k still
    groups fully because membership is transitive across rows."""
    from clipx_torch.search.engine import VectorIndex

    n = vectors.shape[0]
    if n == 0:
        return []
    idx = VectorIndex.from_vectors(vectors, device=device)
    kk = min(k, n)
    parent = np.arange(n)
    score_sum: dict = {}
    for start in range(0, n, batch):
        q = vectors[start: start + batch]
        D, I = idx.search(q, kk)
        for r in range(q.shape[0]):
            qi = start + r
            for s, j in zip(D[r], I[r]):
                j = int(j)
                if j < 0 or j == qi or s < threshold:
                    continue
                ra, rb = _find(parent, qi), _find(parent, j)
                if ra != rb:
                    parent[ra] = rb
                key = (min(qi, j), max(qi, j))
                score_sum[key] = float(s)
    groups: dict = {}
    for i in range(n):
        groups.setdefault(_find(parent, i), []).append(i)
    degree: dict = {}
    for (a, b) in score_sum:
        degree[a] = degree.get(a, 0) + 1
        degree[b] = degree.get(b, 0) + 1
    out = []
    for members in groups.values():
        if len(members) < 2:
            continue
        ms = set(members)
        pair_scores = [v for (a, b), v in score_sum.items()
                       if a in ms and b in ms]
        mean = float(np.mean(pair_scores)) if pair_scores else 0.0
        # best-connected member first (the printed contract: keeping the
        # first line of each block keeps the group's hub)
        members.sort(key=lambda i: (-degree.get(i, 0), i))
        out.append((members, mean))
    out.sort(key=lambda g: -len(g[0]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="find_dupes")
    ap.add_argument("--db", default="vectors.lmdb")
    ap.add_argument("--index", default="images.index")
    ap.add_argument("--threshold", type=float, default=0.96,
                    help="cosine similarity at/above which two photos "
                         "count as duplicates (0.96 catches burst shots "
                         "and re-exports; 0.999 = byte-level re-encodes)")
    ap.add_argument("--neighbors", type=int, default=16,
                    help="nearest neighbours examined per photo; groups "
                         "larger than this still form transitively")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="where the self-search runs (default cuda; cpu "
                         "must be asked for)")
    args = ap.parse_args(argv)
    if not (0.0 < args.threshold <= 1.0):
        print("threshold must be in (0, 1]", file=sys.stderr)
        return 1

    from clipx_torch.search.engine import read_index_vectors
    from clipx_torch.store.kv import open_env

    vectors = read_index_vectors(args.index)
    groups = dupe_groups(vectors, args.threshold, k=args.neighbors,
                         device=args.device)
    # resolve paths only for group members: a point lookup of every row
    # of a 28M-row index would cost GBs of host RAM and minutes
    paths = {}
    env = open_env(args.db)
    idx_db = env.open_db(b"idx_db")
    with env.begin(db=idx_db) as txn:
        for members, _ in groups:
            for i in members:
                raw = txn.get(str(i).encode())
                paths[i] = raw.decode() if raw else f"<id {i}>"
    env.close()
    for members, mean in groups:
        print(f"# group of {len(members)} (mean pair score {mean:.4f})")
        for i in members:
            print(f"{i}\t{paths[i]}")
        print()
    print(f"{len(groups)} duplicate groups across "
          f"{sum(len(m) for m, _ in groups)} of {vectors.shape[0]} "
          f"photos (threshold {args.threshold})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
