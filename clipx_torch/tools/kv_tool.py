"""Storage maintenance for the native KV store and the codes-only
deployment.

    python -m clipx_torch.tools.kv_tool stat vectors.lmdb
    python -m clipx_torch.tools.kv_tool compact vectors.lmdb
    python -m clipx_torch.tools.kv_tool verify vectors.lmdb
    python -m clipx_torch.tools.kv_tool check-index vectors.lmdb \
        --index images.index
    python -m clipx_torch.tools.kv_tool drop-f32 --index images.index

Counterpart of the root ``tools/kv_tool.py``, with its commands, stdout,
exit codes and refusals. ``stat`` prints per-database entry counts and the
store's bytes; ``compact`` rewrites the log with only live records;
``verify`` walks every cursor and cross-checks counts (opening the store
also recovers a torn tail); ``check-index`` cross-checks the sidecar, the
id map and the stored vectors. ``drop-f32`` deletes the f32 sidecar once
the coded deployment provably stands alone: the codes file is fresh
against the sidecar, carries the self-integrity footer, and residual pq has
its matching ``.ivf``; otherwise it refuses (exit 2). Host work only: the
store, the sidecar and the codes file's metadata.
"""

from __future__ import annotations

import argparse
import os

from clipx_torch.store import kv

KNOWN_DBS = [b"fn_db", b"skip_db", b"idx_db"]


def _store_bytes(env_path: str):
    """(segment bytes, wal bytes) of the data-bearing store files."""
    seg = wal = 0
    for f in os.listdir(env_path):
        full = os.path.join(env_path, f)
        if f.endswith(".cxs"):
            seg += os.path.getsize(full)
        elif f.endswith(".cxkv"):
            wal += os.path.getsize(full)
    return seg, wal


def drop_f32(index_path: str) -> int:
    """Delete the f32 sidecar once the coded deployment provably
    stands alone: the codes file must be FRESH against the current
    sidecar, carry the self-integrity footer (codes-only boots verify
    against it), and — for residual pq — have its matching .ivf cache
    on disk (no f32 means no rebuild path). Refuses otherwise."""
    from clipx_torch.search import codes_io, ivf

    cpath = codes_io.codes_path(index_path)
    if not os.path.exists(index_path):
        print(f"{index_path} is already absent")
        return 0
    parsed = codes_io._read_meta(cpath) if os.path.exists(cpath) else None
    if parsed is None:
        print(f"REFUSING: no readable codes file at {cpath} — build one "
              "first (start query/serve once with --corpus-dtype "
              "int8/int4/pq)")
        return 2
    meta = parsed[0]
    if not meta.get("self"):
        print(f"REFUSING: {cpath} predates the self-integrity footer; "
              "codes-only boots could not verify it. Rebuild it once "
              "(CLIPX_CODES=refresh) while the sidecar is present.")
        return 2
    payload = codes_io.load_codes(index_path, meta.get("tier"),
                                  rotated=bool(meta.get("rotated")))
    if payload is None:
        print(f"REFUSING: {cpath} is STALE against {index_path} (or "
              "corrupt) — a codes-only boot would serve old rows. "
              "Rebuild it (CLIPX_CODES=refresh), then retry.")
        return 2
    if payload.get("residual"):
        cache = ivf._load_cache_for_codes(index_path + ".ivf", payload)
        if cache is None:
            print(f"REFUSING: residual codes need {index_path}.ivf "
                  "(matching content hash + layout digest) to boot, "
                  "and it is missing or stale. Start once under "
                  "--search-mode ivf to regenerate it, then retry.")
            return 2
    saved = os.path.getsize(index_path)
    kept = os.path.getsize(cpath)
    os.remove(index_path)
    print(f"dropped {index_path} ({saved / 2**30:.2f} GiB); deployment "
          f"is now codes-only ({cpath}, {kept / 2**30:.2f} GiB"
          + (f" + {index_path}.ivf" if payload.get("residual")
             or os.path.exists(index_path + ".ivf") else "") + ").")
    print("Lost with the sidecar: staleness detection, re-encoding to "
          "other tiers, incremental serve reload. Rebuild it any time "
          "by re-running build-index.py.")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kv_tool")
    ap.add_argument("command",
                    choices=("stat", "compact", "verify", "check-index",
                             "drop-f32"))
    ap.add_argument("env_path", nargs="?",
                    help="store directory (not needed for drop-f32)")
    ap.add_argument("--index", default="images.index",
                    help="vector index file for check-index / drop-f32")
    ap.add_argument("--samples", type=int, default=16)
    args = ap.parse_args(argv)

    if args.command == "drop-f32":
        return drop_f32(args.index)
    if args.env_path is None or not os.path.isdir(args.env_path):
        print(f"no environment at {args.env_path!r}")
        return 1
    env = kv.open_env(args.env_path)
    try:
        if args.command == "stat":
            total = 0
            for name in KNOWN_DBS:
                db = env.open_db(name)
                with env.begin(db=db) as txn:
                    n = txn.stat()["entries"]
                total += n
                print(f"{name.decode():8s} {n:>10,} entries")
            seg, wal = _store_bytes(args.env_path)
            print(f"{'total':8s} {total:>10,} entries; generation "
                  f"{env.generation()}; segment {seg:,} bytes, "
                  f"wal {wal:,} bytes")
        elif args.command == "compact":
            before = sum(_store_bytes(args.env_path))
            env.compact()
            after = sum(_store_bytes(args.env_path))
            print(f"compacted: {before:,} -> {after:,} bytes "
                  f"(generation {env.generation()})")
        elif args.command == "check-index":
            # cross-check images.index <-> idx_db <-> fn_db: same count,
            # ids in byte-sorted path order, vectors bit-identical.
            # (The reference's repair story is "rerun the indexer";
            # this tells you whether you need to.)
            import numpy as np

            from clipx_torch.search.engine import read_index_vectors

            vectors = read_index_vectors(args.index, mmap=True)
            fn_db = env.open_db(b"fn_db")
            idx_db = env.open_db(b"idx_db")
            with env.begin(db=idx_db) as txn:
                n_ids = txn.stat()["entries"]
            with env.begin(db=fn_db) as txn:
                n_fn = txn.stat()["entries"]
                sorted_paths = [k for k, _ in txn.cursor()]
            ok = True
            if not (len(vectors) == n_ids == n_fn):
                print(f"COUNT MISMATCH: index {len(vectors)}, "
                      f"idx_db {n_ids}, fn_db {n_fn}")
                ok = False
            n = min(len(vectors), n_ids, n_fn)
            step = max(1, n // max(args.samples, 1))
            with env.begin() as txn:
                for i in range(0, n, step):
                    path = txn.get(str(i).encode(), db=idx_db)
                    if path != sorted_paths[i]:
                        print(f"ID ORDER MISMATCH at {i}")
                        ok = False
                        continue
                    stored = np.frombuffer(txn.get(path, db=fn_db),
                                           dtype=np.float32)
                    if not np.array_equal(vectors[i], stored):
                        print(f"VECTOR MISMATCH at id {i} "
                              f"({path.decode()})")
                        ok = False
            if not ok:
                print("check-index: STALE — rerun build-index.py to "
                      "rebuild idx_db and the index from fn_db")
                return 2
            print(f"check-index: OK ({n} rows consistent)")
        else:  # verify
            ok = True
            for name in KNOWN_DBS:
                db = env.open_db(name)
                with env.begin(db=db) as txn:
                    expected = txn.stat()["entries"]
                    count = 0
                    last = None
                    for key, _ in txn.cursor():
                        if last is not None and key <= last:
                            print(f"ORDER VIOLATION in {name.decode()}")
                            ok = False
                        last = key
                        count += 1
                if count != expected:
                    print(f"COUNT MISMATCH in {name.decode()}: "
                          f"cursor {count} vs stat {expected}")
                    ok = False
                print(f"{name.decode():8s} {count:>10,} rows, sorted")
            if not ok:
                return 2
            print("verify: OK")
    finally:
        env.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
