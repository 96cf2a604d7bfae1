"""``python -m clipx_torch.cli.build_index DIR/ ...`` — the indexer CLI.

Counterpart of ``clipx/cli/build_index.py``, with the same contract
(reference:build-index.py): folders scanned non-recursively with paths
formed by string concatenation (pass dirs with a trailing slash); files in
skip_db are skipped for good and files already in fn_db are not encoded
again; a decode failure prints ``#`` and lands in skip_db, each encoded
image prints ``.``; Ctrl-C (or SIGTERM) during encoding still builds the
index over what was encoded; phase 2 assigns ids in byte-sorted path order
into idx_db and streams the vectors into ``images.index``. Stdout is
clipx's, line for line; per-stage throughput goes to stderr.

Images stream through a host decode pool into batched GPU encodes, with up
to ``PIPELINE_DEPTH`` batches in flight (``Encoder.encode_images_async``).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
from typing import List

import numpy as np

from clipx_torch.cli import common
from clipx_torch.data.pipeline import batched, iter_decoded, scan_folder
from clipx_torch.search.engine import IndexWriter
from clipx_torch.store.kv import open_env
from clipx_torch.utils.locking import LockHeldError, SingleWriterLock
from clipx_torch.utils.profiling import StageTimers, device_trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="build-index.py")
    common.add_model_flags(p)
    p.add_argument("--batch-size", type=int,
                   default=int(os.environ.get("CLIPX_BATCH_SIZE", "128")))
    p.add_argument("--decode-workers", type=int,
                   default=int(os.environ.get("CLIPX_DECODE_WORKERS", "4")))
    p.add_argument("--decode-backend", choices=("cv2", "pil"), default="cv2")
    env_fast = os.environ.get("CLIPX_FAST_DECODE", "").lower()
    p.add_argument("--fast-decode", action=argparse.BooleanOptionalAction,
                   default=env_fast in ("1", "true", "yes", "on"),
                   help="reduced-resolution JPEG decode (DCT-domain; "
                        "pixels differ slightly from a full decode). "
                        "--no-fast-decode overrides $CLIPX_FAST_DECODE")
    p.add_argument("--preprocess", choices=("host", "device"),
                   default=os.environ.get("CLIPX_PREPROCESS", "host"),
                   help="host: resize+crop on the CPU (device is not "
                        "ported yet)")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the encode phase")
    p.add_argument("dirs", nargs="*")
    return p


def main(argv: List[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = build_parser().parse_args(argv)
    common.check_ported(args)

    try:
        lock = SingleWriterLock(args.db)
        lock.acquire()
    except LockHeldError as exc:
        print(f"error: {exc}")
        return 1

    timers = StageTimers()
    encoder = common.make_encoder(args)
    env = open_env(args.db, map_size=common.DEFAULT_MAP_SIZE, max_dbs=4)
    fn_db = env.open_db(common.FN_DB)
    skip_db = env.open_db(common.SKIP_DB)

    # SIGTERM rides the reference's Ctrl-C contract: during the encode loop
    # it breaks out but still builds the index over what was encoded
    prev_term = None
    try:
        prev_term = signal.signal(
            signal.SIGTERM,
            lambda *_: (_ for _ in ()).throw(KeyboardInterrupt()))
    except ValueError:  # not the main thread
        pass
    try:
        try:
            with device_trace(args.trace_dir):
                _encode_phase(args, encoder, env, fn_db, skip_db, timers)
        except KeyboardInterrupt:
            print("Interrupted!")

        with timers.stage("index_build"):
            _index_phase(args, env)
        print("Done!")
        timers.emit()
        env.close()
        lock.release()
        return 0
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)


# ---------------------------------------------------------------------------
# phase 1: streaming encode
# ---------------------------------------------------------------------------

def _pending_paths(env, fn_db, skip_db, base_path: str) -> List[str]:
    paths = scan_folder(base_path)
    todo = []
    with env.begin(db=skip_db) as skip_txn, env.begin(db=fn_db) as txn:
        for tfn in paths:
            key = tfn.encode()
            if skip_txn.get(key) is not None:  # permanent skip
                continue
            if txn.get(key) is not None:       # already indexed
                continue
            todo.append(tfn)
    return todo


# encode batches kept in flight: the GPU encodes batch N while the host
# decodes and writes back around it
PIPELINE_DEPTH = 2


def _encode_phase(args, encoder, env, fn_db, skip_db,
                  timers: StageTimers) -> None:
    size = encoder.image_size
    for base_path in args.dirs:
        print(f"CLIPing {base_path}...")
        with timers.stage("scan"):
            todo = _pending_paths(env, fn_db, skip_db, base_path)
        stream = iter_decoded(todo, size, backend=args.decode_backend,
                              workers=args.decode_workers,
                              prefetch=max(args.batch_size * 2, 64),
                              fast=args.fast_decode)
        in_flight = []  # (good_items, async_handle)

        def drain_one():
            good, handle = in_flight.pop(0)
            with timers.stage("encode_wait", items=len(good)):
                embs = encoder.finalize(handle)
            with timers.stage("writeback"):
                with env.begin(db=fn_db, write=True) as txn:
                    for it, emb in zip(good, embs):
                        txn.put(it.path.encode(),
                                emb.astype(np.float32).tobytes())
            print("." * len(good), end="", flush=True)

        for batch in batched(stream, args.batch_size):
            failed = [it for it in batch if it.array is None]
            good = [it for it in batch if it.array is not None]
            if failed:
                with env.begin(db=skip_db, write=True) as skip_txn:
                    for it in failed:
                        skip_txn.put(it.path.encode(), b"1")
                        print("#", end="", flush=True)
            if good:
                with timers.stage("encode_dispatch", items=len(good)):
                    arrays = np.stack([it.array for it in good])
                    in_flight.append(
                        (good, encoder.encode_images_async(arrays)))
                if len(in_flight) > PIPELINE_DEPTH:
                    drain_one()
        while in_flight:
            drain_one()
        print(flush=True)


# ---------------------------------------------------------------------------
# phase 2: id assignment + index build
# ---------------------------------------------------------------------------

# host-RAM bound for matrix assembly: vectors stream to the sidecar in
# chunks of this many rows
ASSEMBLY_CHUNK = 65536


def _index_phase(args, env) -> None:
    fn_db = env.open_db(common.FN_DB)
    idx_db = env.open_db(common.IDX_DB)
    with env.begin(db=fn_db) as txn:
        n = txn.stat()["entries"]
        if n == 0:
            return
        print(f"Preparing index for {n} entries...")
        writer = None
        chunk = []
        i = 0
        pending = []
        # sorted-cursor iteration: id i == rank of the path in byte order
        for tfn, raw in txn.cursor():
            v = np.frombuffer(raw, dtype=np.float32)
            if writer is None:
                print(f"Generating ({n}, {v.shape[0]}) matrix...")
                writer = IndexWriter(args.index, n, v.shape[0])
            chunk.append(v)
            pending.append((f"{i}".encode(), tfn))
            i += 1
            if len(pending) >= 10000:
                _flush_ids(env, idx_db, pending)
            if len(chunk) >= ASSEMBLY_CHUNK:
                writer.write(np.stack(chunk))
                chunk = []
        _flush_ids(env, idx_db, pending)
        if writer is None:
            return
        print("Adding to index...")
        if chunk:
            writer.write(np.stack(chunk))
        print("Saving index...")
        writer.close()


def _flush_ids(env, idx_db, pending) -> None:
    if not pending:
        return
    with env.begin(db=idx_db, write=True) as idx_txn:
        for key, tfn in pending:
            idx_txn.put(key, tfn, dupdata=False, overwrite=True)
    pending.clear()


if __name__ == "__main__":
    raise SystemExit(main())
