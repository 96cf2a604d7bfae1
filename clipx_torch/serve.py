"""``python -m clipx_torch.serve`` — the HTTP search service on the card.

Counterpart of ``clipx/serve.py``: the same JSON API, status codes and
error strings, the same query coalescer, cold-shape gate, warm-up manifest
and ``/reload``, over the port's encoder, index and store (on ``--device``,
default cuda; no GPU and no ``--device cpu`` exits with a message).

Endpoints (all JSON):

    GET  /healthz                          -> {"status": "ok", ...}
    GET  /metrics                          -> counters, latency, uptime
    GET  /search?q=TEXT&k=K[&offset=N]     -> ranked text-query results
    GET  /similar?id=ID&k=K[&offset=N]     -> image-similarity by stored id
    POST /encode_text   {"texts": [...]}   -> embeddings
    POST /encode_image  {"images_b64": [...]} -> embeddings (<= 64 a
                                              request; the indexer's decode
                                              and preprocess)
    POST /search_image  {"image_b64": "...", "k": K} -> search by a new
                                              image
    POST /search_vector {"vector": [...], "k": K}
    POST /reload                           -> swap in the rebuilt on-disk
                                              index without a restart

Results are rows of score, id and path with rank 0 included (the REPL's
rank-0 skip is a display quirk of the CLI, not of the API).

Concurrent single-row searches and single-text encodes are coalesced into
batched calls (``$CLIPX_SERVE_COALESCE``, default 16; 0 or 1 disables;
``$CLIPX_SERVE_INFLIGHT`` batches in flight, default 4).

Warm-up and the cold-shape gate (``$CLIPX_SERVE_COLD_GUARD`` on, warmup or
off; ``$CLIPX_SERVE_RETRY_AFTER`` seconds). On the card nothing is compiled
per shape, but a shape's first use still costs: the kernel libraries'
``nvcc`` build (``ops/_build.py``), cuBLAS handle and workspace creation,
and the caching allocator's first blocks for a bucket. Warm-up builds and
loads every kernel library before it marks the search and image families
ready, and runs every text bucket, search Q bucket and image bucket a live
request can reach, so no request waits on ``nvcc``. Until a family is warm
its requests answer 503 with ``Retry-After``; after warm-up a shape key
never seen before answers 503 once while it runs off-thread, and lands in
``<index>.warmup.json`` (clipx's format, so a manifest written by either
package replays in the other).

    python -m clipx_torch.serve --port 8765 --model ViT-B/32 \\
        --checkpoint vit_b32.npz

``--sharded on`` (or ``auto`` with more than one GPU visible) row-shards the
index over the visible devices (``parallel/mips.py``, ``ShardedIVFIndex``);
an incremental ``/reload`` appends only the delta to its shards.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from clipx_torch.cli import common
from clipx_torch.store.kv import open_env
from clipx_torch.utils import profiling


class _Pending:
    """One enqueued item awaiting a coalescing dispatcher."""

    __slots__ = ("item", "done", "result", "error")

    def __init__(self, item):
        self.item = item
        self.done = threading.Event()
        self.result = self.error = None


class _Coalescer:
    """Batch concurrent single-item device calls into one batched call.

    ``run_batch(items) -> [result, ...]`` does the device work. Batches run
    on a pool of ``inflight`` workers, so one batch's host work (upload,
    top-k readback) overlaps another's device work. The dispatcher acquires
    an in-flight slot BEFORE dequeuing: while every slot is busy the queue
    accumulates, and the batch sliced after the acquire is as full as the
    backlog allows (up to ``cap``).
    """

    def __init__(self, run_batch, cap: int, inflight: int,
                 name: str = "coalesce"):
        from concurrent.futures import ThreadPoolExecutor

        self._run = run_batch
        self.cap = cap
        self.inflight = inflight
        self._queue = []
        self._cv = threading.Condition()
        self._stop = False
        self._stats_lock = threading.Lock()
        self.batches = 0
        self.queries = 0
        self._pool = ThreadPoolExecutor(
            max_workers=inflight, thread_name_prefix=f"clipx-{name}")
        self._slots = threading.Semaphore(inflight)
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"clipx-{name}-dispatch")
        self._thread.start()

    def submit(self, item):
        """Enqueue one item; block until its batch lands; return its
        result (or raise the batch's error)."""
        p = _Pending(item)
        with self._cv:
            if self._stop:
                stopped = True
            else:
                self._queue.append(p)
                self._cv.notify_all()
                stopped = False
        if stopped:
            # close() raced this submit: an enqueued item would never
            # drain, so run it inline
            return self._run([item])[0]
        if not p.done.wait(timeout=600.0):
            raise RuntimeError("coalesced call timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self) -> None:
        """Stop the dispatcher (drains queued items first)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10)
        self._pool.shutdown(wait=True)

    def stats(self) -> dict:
        with self._stats_lock:
            return {"batches": self.batches, "queries": self.queries,
                    "cap": self.cap, "inflight": self.inflight}

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if not self._queue:  # stop requested and drained
                    return
            # the slot first, then the slice (see the class docstring);
            # dequeue-then-block would trap early queries while later
            # ones overtake
            self._slots.acquire()
            with self._cv:
                batch = self._queue[: self.cap]
                del self._queue[: self.cap]
            if not batch:       # raced with another drain
                self._slots.release()
                continue
            self._pool.submit(self._run_one, batch)

    def _run_one(self, batch) -> None:
        try:
            try:
                results = self._run([p.item for p in batch])
            except Exception as exc:  # noqa: BLE001 — fail the whole batch
                for p in batch:
                    p.error = exc
                    p.done.set()
                return
            with self._stats_lock:
                self.batches += 1
                self.queries += len(batch)
            for p, r in zip(batch, results):
                p.result = r
                p.done.set()
        finally:
            self._slots.release()


class ColdShapeError(RuntimeError):
    """A request needs a shape warm-up has not run yet: the client gets an
    immediate 503 + Retry-After instead of waiting behind the first use
    (a kernel build, cuBLAS set-up, the allocator's first blocks)."""

    def __init__(self, family: str, retry_after: int):
        super().__init__(
            f"warming up: {family} shapes are still compiling; "
            f"retry in ~{retry_after}s")
        self.family = family
        self.retry_after = retry_after


class _WarmGate:
    """Tracks warmed shapes at two granularities.

    Family phase (text / search / image): while warm-up runs a family's
    baseline shapes, every request in that family answers 503; the warm-up
    thread marks each family as it finishes (and all of them on exit, so a
    failed best-effort warm-up never leaves the gate closed).

    Shape keys (``keep_armed``, the default): warm-up also records each
    shape it ran (text bucket, image bucket, search ``index.shape_key``).
    After warm-up a request whose key was never run answers 503 while the
    service runs it off-thread (``SearchService._bg_compile``), then
    passes. ``$CLIPX_SERVE_COLD_GUARD``: 'on' (both layers), 'warmup'
    (family phase only), 'off' (no gate)."""

    FAMILIES = ("text", "search", "image")

    def __init__(self, retry_after: int, keep_armed: bool = True):
        self.retry_after = retry_after
        self.keep_armed = keep_armed
        self._ready = set()
        self._keys = set()
        self._lock = threading.Lock()

    def mark(self, family: str) -> None:
        with self._lock:
            self._ready.add(family)

    def mark_all(self) -> None:
        with self._lock:
            self._ready.update(self.FAMILIES)

    def ready(self, family: str) -> bool:
        with self._lock:
            return family in self._ready

    def all_ready(self) -> bool:
        with self._lock:
            return set(self.FAMILIES) <= self._ready

    def mark_key(self, key: tuple) -> None:
        with self._lock:
            self._keys.add(key)

    def key_ready(self, key: tuple) -> bool:
        with self._lock:
            return key in self._keys


class SearchService:
    """Owns the store, the index and the (lazy) encoder; thread-safe
    searches. ``encoder``: an Encoder to serve with instead of building one
    from the flags (an embedding caller that already holds one)."""

    def __init__(self, args, encoder=None):
        from clipx_torch.search.engine import content_hash, read_index_vectors

        self.args = args
        self.env = open_env(args.db, map_size=common.DEFAULT_MAP_SIZE,
                            max_dbs=4)
        self.idx_db = self.env.open_db(common.IDX_DB)
        self.fn_db = self.env.open_db(common.FN_DB)
        # the REPL's index selection (--search-mode, --corpus-dtype). Coded
        # tiers boot from a fresh <index>.codes, whose recorded content
        # hash seeds the incremental-reload fingerprint; otherwise the
        # sidecar is read here so the fingerprint comes with the read
        self.index = None
        coded = common.load_coded_index(args)
        if coded is not None:
            ch = getattr(coded, "_boot_content_hash", None)
            if ch is None:
                from clipx_torch.search import codes_io

                ch = codes_io.sidecar_full_hash(args.index)
            if ch is not None or not os.path.exists(args.index):
                # None only on a codes-only boot from a hashless codes
                # file: no incremental reload there
                self.index = coded
                self._sidecar_hash = ch
                self._sidecar_n = coded.ntotal
        if self.index is None:
            vectors = read_index_vectors(args.index)
            self._sidecar_hash = content_hash(vectors)
            self._sidecar_n = vectors.shape[0]
            self.index = common.build_index_from_vectors(vectors, args)
            del vectors
        self._reload_lock = threading.Lock()
        # cleared while reload mutates the index (drop-first rebuild or an
        # in-place add) — see reload()
        self._index_ready = threading.Event()
        self._index_ready.set()
        # searches register as readers, so reload's in-place add never
        # writes the corpus under a running search
        self._readers = 0
        self._readers_cv = threading.Condition()
        self._encoder = encoder
        # the encoder build holds _enc_lock for a model load; counters,
        # /similar and /metrics only need the cheap _stats_lock
        self._enc_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.counters = {"search": 0, "similar": 0, "encode_text": 0,
                         "encode_image": 0, "search_image": 0,
                         "search_vector": 0, "errors": 0, "reloads": 0}
        self._latency_sum = 0.0
        self._latency_n = 0
        self.started = time.time()
        cap = int(os.environ.get("CLIPX_SERVE_COALESCE", "16"))
        cap = cap if cap >= 2 else 0
        inflight = max(1, int(os.environ.get("CLIPX_SERVE_INFLIGHT", "4")))
        self._search_co = self._text_co = None
        if cap:
            self._search_co = _Coalescer(
                self._search_batch, cap, inflight, name="search")
            self._text_co = _Coalescer(
                self._encode_batch, cap, inflight, name="text")
        # attached by make_server when --warmup is on (see _WarmGate)
        self._warm_gate: Optional[_WarmGate] = None
        # off-thread runs of novel shapes (deduped by shape key)
        self._bg_lock = threading.Lock()
        self._bg_pending = set()

    def _require_warm(self, family: str, key: tuple = None,
                      spec=None) -> None:
        """The two-layer gate (see _WarmGate): family phase during
        warm-up; per shape key after it. A novel key after warm-up starts
        an off-thread run and answers 503 until it lands."""
        g = self._warm_gate
        if g is None:
            return
        if not g.ready(family):
            raise ColdShapeError(family, g.retry_after)
        if (key is None or not g.keep_armed or g.key_ready(key)):
            return
        self._bg_compile(family, key, spec)
        raise ColdShapeError(f"{family} shape {key}", g.retry_after)

    # -- off-thread shape runs + the warm-up manifest ------------------------

    def _bg_compile(self, family: str, key: tuple, spec) -> None:
        """Run a novel shape off the request path, one thread per distinct
        key. On completion, success or failure, the key is marked ready,
        so the worst case is the lazy first use of --no-warmup, never a
        503 forever."""
        with self._bg_lock:
            if key in self._bg_pending:
                return
            self._bg_pending.add(key)
        t = threading.Thread(target=self._bg_compile_run,
                             args=(family, key, spec), daemon=True,
                             name=f"clipx-bgcompile-{family}")
        t.start()

    def _bg_compile_run(self, family: str, key: tuple, spec) -> None:
        try:
            if family == "search":
                rows, nprobe = spec
                cap = min(self._search_co.cap
                          if self._search_co is not None else 1, 16)
                self._begin_read(timeout=1200.0)
                try:
                    idx = self.current_index()
                    kw = ({"nprobe": nprobe}
                          if nprobe is not None
                          and getattr(idx, "supports_nprobe", False)
                          else {})
                    q = 1
                    while q <= cap:
                        idx.search(np.zeros((q, idx.dim), np.float32),
                                   rows, **kw)
                        q *= 2
                finally:
                    self._end_read()
            elif family == "text":
                self.encoder().encode_texts(["warmup"] * int(spec))
            else:  # image
                enc = self.encoder()
                zero = np.zeros((int(spec), enc.image_size,
                                 enc.image_size, 3), np.uint8)
                enc.encode_images(zero)
            self.count("bg_compiles")
            self._manifest_add(family, spec)
        except Exception:  # noqa: BLE001 — degrade to the lazy first use
            pass
        finally:
            g = self._warm_gate
            if g is not None:
                g.mark_key(key)
            with self._bg_lock:
                self._bg_pending.discard(key)

    def _manifest_path(self) -> str:
        return self.args.index + ".warmup.json"

    def _manifest_entries(self) -> list:
        """Shapes this index and config needed in past runs, replayed by
        warm-up so a restart does not rediscover them through 503s."""
        try:
            with open(self._manifest_path()) as f:
                data = json.load(f)
            ent = data.get("entries", [])
            return ent if isinstance(ent, list) else []
        except (OSError, ValueError):
            return []

    def _manifest_add(self, family: str, spec) -> None:
        if family == "search":
            entry = {"family": "search", "k": int(spec[0]),
                     "nprobe": spec[1]}
        else:
            entry = {"family": family, "n": int(spec)}
        with self._bg_lock:
            entries = self._manifest_entries()
            if entry in entries:
                return
            entries.append(entry)
            tmp = self._manifest_path() + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump({"model": self.args.model,
                               "entries": entries}, f, indent=1)
                os.replace(tmp, self._manifest_path())
            except OSError:
                pass  # unwritable dir: the manifest is best-effort

    def close(self) -> None:
        """Stop the coalescing dispatchers (each drains its queue)."""
        for co in (self._search_co, self._text_co):
            if co is not None:
                co.close()
        self._search_co = self._text_co = None

    def _search_batch(self, items):
        """Coalescer backend: items are (features_row, rows) pairs."""
        feats = np.concatenate([f for f, _ in items], axis=0)
        rows = max(r for _, r in items)
        self._begin_read()
        try:
            D, I = self.current_index().search(feats, rows)
        finally:
            self._end_read()
        return [(D[i: i + 1], I[i: i + 1]) for i in range(len(items))]

    def _encode_batch(self, texts):
        """Coalescer backend: items are raw query strings."""
        emb = self.encoder().encode_texts(list(texts))
        return [emb[i: i + 1] for i in range(len(texts))]

    def encode_texts(self, texts) -> np.ndarray:
        """Text -> embedding rows. Single texts (every /search request)
        ride the text coalescer; multi-text callers go inline."""
        from clipx_torch.runtime.encoder import _TEXT_BUCKETS, _pick_bucket

        nb = _pick_bucket(min(len(texts), _TEXT_BUCKETS[-1]),
                          _TEXT_BUCKETS)
        self._require_warm("text", key=("text", nb), spec=nb)
        if self._text_co is not None and len(texts) == 1:
            return self._text_co.submit(str(texts[0]))
        return self.encoder().encode_texts([str(t) for t in texts])

    # rows per image encode call: requests chunk to this, so the only image
    # buckets a live request reaches are 1 and _IMG_CHUNK, both warmed
    _IMG_CHUNK = 8

    def encode_images_b64(self, images_b64) -> np.ndarray:
        """base64 image bytes -> embedding rows, through the indexer's
        default decode and preprocess (``data.pipeline.decode_bytes_rgb``),
        so a posted copy of an indexed file reproduces its stored vector
        (for an index built with that default)."""
        import base64

        from clipx_torch.data.pipeline import decode_bytes_rgb

        self._require_warm("image")
        enc = self.encoder()
        if self._warm_gate is not None:
            from clipx_torch.runtime.encoder import _pick_bucket

            n = len(images_b64)
            sizes = {min(self._IMG_CHUNK, n - i)
                     for i in range(0, max(n, 1), self._IMG_CHUNK)}
            for b in sorted({_pick_bucket(s, enc.buckets)
                             for s in sizes}):
                self._require_warm("image", key=("image", b), spec=b)
        out = []
        for i, b in enumerate(images_b64):
            try:
                raw = base64.b64decode(b, validate=True)
                out.append(decode_bytes_rgb(
                    np.frombuffer(raw, np.uint8), enc.image_size))
            except Exception as exc:
                raise ValueError(
                    f"images_b64[{i}]: {type(exc).__name__}: {exc}"
                ) from exc
        batch = np.stack(out)
        step = self._IMG_CHUNK
        return np.concatenate([enc.encode_images(batch[i: i + step])
                               for i in range(0, len(out), step)])

    # the encoder is built on the first request that needs it (/similar
    # never does)
    def encoder(self):
        with self._enc_lock:
            if self._encoder is None:
                self._encoder = common.make_encoder(self.args)
            return self._encoder

    def count(self, key: str) -> None:
        with self._stats_lock:
            self.counters[key] = self.counters.get(key, 0) + 1

    def current_index(self, timeout: float = 300.0):
        """The live index; blocks through a drop-first rebuild window."""
        idx = self.index
        if idx is None:
            self._index_ready.wait(timeout)
            idx = self.index
            if idx is None:
                raise RuntimeError("index is reloading")
        return idx

    def _begin_read(self, timeout: float = 300.0):
        """Register a reader. Readers run concurrently; reload excludes
        them only for its mutation window. The ready check and the count
        increment are atomic under the condition variable, so no reader
        slips in between reload clearing the gate and draining the
        count."""
        deadline = time.time() + timeout
        with self._readers_cv:
            while not self._index_ready.is_set():
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise RuntimeError("index is reloading")
                self._readers_cv.wait(min(remaining, 1.0))
            self._readers += 1

    def _end_read(self):
        with self._readers_cv:
            self._readers -= 1
            self._readers_cv.notify_all()

    def _exclude_readers(self, timeout: float = 300.0):
        """Called with _index_ready cleared: wait for running searches to
        finish before the index is written or dropped."""
        deadline = time.time() + timeout
        with self._readers_cv:
            while self._readers > 0:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise RuntimeError("readers did not drain for reload")
                self._readers_cv.wait(remaining)

    def reload(self) -> dict:
        """Swap in the current on-disk index and fold in store updates:
        rebuild with build_index, then POST /reload.

        Incremental when the new sidecar is the old corpus plus appended
        rows (its prefix content hash matches, so ids, the byte-sorted path
        ranks, are unchanged): only the delta goes to ``index.add``.
        Otherwise a full rebuild that drops the old device index first, so
        the card never holds two corpora; searches wait out the window."""
        from clipx_torch.search.engine import content_hash, read_index_vectors

        with self._reload_lock:
            if not os.path.exists(self.args.index):
                # codes-only deployment: nothing to diff a reload against
                raise ValueError(
                    "reload unavailable: codes-only deployment (f32 "
                    f"sidecar {self.args.index} absent). Rebuild the "
                    "sidecar with build-index.py, or restart serve "
                    "after replacing the codes file.")
            vectors = read_index_vectors(self.args.index)
            old = self.index
            prev_ntotal = old.ntotal if old is not None else 0
            search_mode = getattr(self.args, "search_mode", "auto")
            incremental = (
                old is not None and hasattr(old, "add")
                and old.ntotal == self._sidecar_n
                and vectors.shape[0] >= self._sidecar_n
                and content_hash(vectors[: self._sidecar_n])
                == self._sidecar_hash)
            if incremental:
                delta = vectors[self._sidecar_n:]
                if delta.shape[0]:
                    # the add writes the corpus in place (or regrows it):
                    # no search may run against it meanwhile
                    self._index_ready.clear()
                    try:
                        self._exclude_readers()
                        old.add(delta)
                        # crossing the quant-auto threshold arms the int8
                        # scan
                        common.apply_search_mode(old, search_mode)
                    finally:
                        self._index_ready.set()
                        with self._readers_cv:
                            self._readers_cv.notify_all()
                mode = "incremental"
            else:
                self._index_ready.clear()
                try:
                    # drain running searches BEFORE dropping the old
                    # corpus: a search holding it would keep it on the
                    # card through the new upload
                    self._exclude_readers()
                    self.index = None
                    del old  # free the device corpus before the upload
                    self.index = common.build_index_from_vectors(
                        vectors, self.args)
                finally:
                    self._index_ready.set()
                    with self._readers_cv:
                        self._readers_cv.notify_all()
                mode = "rebuild"
            self._sidecar_hash = content_hash(vectors)
            self._sidecar_n = vectors.shape[0]
            self.env.refresh()
            self.count("reloads")
            return {"ntotal": self.index.ntotal,
                    "previous_ntotal": prev_ntotal, "mode": mode}

    def _index_info(self, idx) -> Optional[dict]:
        """The live index's storage tier, class, and whether this process
        booted from the codes file."""
        if idx is None:
            return None
        tier = ("pq" if getattr(idx, "pq_storage", False)
                else "int4" if getattr(idx, "int4_storage", False)
                else "int8" if getattr(idx, "int8_storage", False)
                else "float")
        info = {"class": type(idx).__name__, "storage": tier,
                "booted_from_codes": getattr(idx, "_boot_content_hash",
                                             None) is not None}
        if getattr(idx, "supports_nprobe", False):
            info["nprobe_default"] = idx.nprobe
            info["residual"] = bool(getattr(idx, "_residual", False))
        return info

    def metrics(self) -> dict:
        idx = self.index  # None mid-rebuild; metrics never block
        idle = {"batches": 0, "queries": 0, "cap": 0, "inflight": 0}
        with self._stats_lock:
            avg = (self._latency_sum / self._latency_n
                   if self._latency_n else None)
            return {
                "uptime_s": round(time.time() - self.started, 1),
                "index": self._index_info(idx),
                "ntotal": idx.ntotal if idx is not None else None,
                "counters": dict(self.counters),
                "search_latency_avg_s": (round(avg, 6)
                                         if avg is not None else None),
                "encoder_loaded": self._encoder is not None,
                "coalesce": (self._search_co.stats()
                             if self._search_co is not None else idle),
                "text_coalesce": (self._text_co.stats()
                                  if self._text_co is not None else idle),
            }

    def lookup_path(self, i: int) -> Optional[str]:
        with self.env.begin(db=self.idx_db) as txn:
            raw = txn.get(f"{i}".encode())
        return raw.decode() if raw is not None else None

    def stored_vector(self, image_id: int) -> Optional[np.ndarray]:
        path = self.lookup_path(image_id)
        if path is None:
            return None
        with self.env.begin(db=self.fn_db) as txn:
            raw = txn.get(path.encode())
        if raw is None:
            return None
        return np.frombuffer(raw, dtype=np.float32).reshape(1, -1)

    def search(self, features: np.ndarray, k: int, offset: int = 0,
               nprobe: int = None):
        """The top ``k`` rows after ``offset`` for the first query row, with
        their paths. Spans: ``serve.search`` (the whole call, ``n`` the
        query rows) and in it ``serve.answer`` (the store lookups, ``n``
        the rows looked up)."""
        with profiling.span("serve.search") as whole:
            self._require_warm("search")
            if self._warm_gate is not None:
                idx = self.current_index()
                np_eff = (nprobe if getattr(idx, "supports_nprobe", False)
                          else None)
                self._require_warm(
                    "search",
                    key=("search",) + tuple(idx.shape_key(k + offset,
                                                          np_eff)),
                    spec=(k + offset, np_eff))
            t0 = time.perf_counter()
            features = np.atleast_2d(np.asarray(features))
            if whole is not None:
                whole.n = features.shape[0]
            # a per-request nprobe binds only under --search-mode ivf;
            # otherwise it is accepted and ignored, like the REPL's 'p N'
            ivf_override = (nprobe is not None
                            and getattr(self.current_index(),
                                        "supports_nprobe", False))
            if (self._search_co is not None and features.shape[0] == 1
                    and not ivf_override):
                # single-row queries ride the coalescer; multi-row callers
                # and nprobe overrides (which cannot share a call with
                # default-probe neighbours) dispatch inline
                D, I = self._search_co.submit(
                    (np.ascontiguousarray(features, dtype=np.float32),
                     k + offset))
            else:
                self._begin_read()
                try:
                    idx = self.current_index()
                    if ivf_override:
                        D, I = idx.search(features, k + offset,
                                          nprobe=nprobe)
                    else:
                        D, I = idx.search(features, k + offset)
                finally:
                    self._end_read()
            dt = time.perf_counter() - t0
            with self._stats_lock:
                self._latency_sum += dt
                self._latency_n += 1
            with profiling.span("serve.answer") as answer:
                results = []
                for j in range(offset, min(k + offset, I.shape[1])):
                    i = int(I[0][j])
                    if i < 0:
                        break
                    results.append({"rank": j, "score": float(D[0][j]),
                                    "id": i, "path": self.lookup_path(i)})
                if answer is not None:
                    answer.n = len(results)
            return {"results": results, "search_time_s": round(dt, 6)}


# Upper bound on accepted POST bodies: the largest legitimate payload (a
# /search_vector query at dim 1024) is a few KB; 8 MB leaves room for
# encode_text batches while keeping a hostile Content-Length out of RAM.
MAX_POST_BYTES = 8 * 1024 * 1024


def _validated_k_offset(k, offset) -> tuple:
    k, offset = int(k), int(offset)
    if k < 1 or k > 1000 or offset < 0:
        raise ValueError("k must be 1..1000, offset >= 0")
    return k, offset


def _validated_nprobe(nprobe):
    """The optional per-request probe knob (the REPL's 'p N'): 1..100 or
    absent."""
    if nprobe is None:
        return None
    nprobe = int(nprobe)
    if nprobe < 1 or nprobe > 100:
        raise ValueError("nprobe must be 1..100")
    return nprobe


class Handler(BaseHTTPRequestHandler):
    service: SearchService = None  # bound by make_server

    # -- plumbing -----------------------------------------------------------
    def log_message(self, fmt, *fmt_args):  # quiet by default
        if os.environ.get("CLIPX_SERVE_VERBOSE"):
            super().log_message(fmt, *fmt_args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bad(self, msg: str, code: int = 400) -> None:
        self.service.count("errors")
        self._json(code, {"error": msg})

    def _cold(self, exc: "ColdShapeError") -> None:
        """503 + Retry-After while the needed shape warms up; not counted
        as an error (the client is told when to come back)."""
        self.service.count("cold_rejects")
        body = json.dumps({"error": str(exc),
                           "warming": exc.family,
                           "retry_after_s": exc.retry_after}).encode()
        self.send_response(503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", str(exc.retry_after))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- GET ----------------------------------------------------------------
    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            if url.path == "/healthz":
                # never blocks: a rebuild's no-index window must not hang
                # a load balancer's health probe
                idx = self.service.index
                gate = self.service._warm_gate
                warm = gate is None or gate.all_ready()
                if idx is None:
                    self._json(503, {"status": "reloading",
                                     "ntotal": None, "dim": None,
                                     "warm": warm})
                else:
                    self._json(200, {"status": "ok",
                                     "ntotal": idx.ntotal,
                                     "dim": idx.dim,
                                     "warm": warm})
            elif url.path == "/metrics":
                self._json(200, self.service.metrics())
            elif url.path == "/search":
                text = q.get("q", "")
                if not text:
                    return self._bad("missing q parameter")
                k, offset = _validated_k_offset(q.get("k", "50"),
                                                q.get("offset", "0"))
                nprobe = _validated_nprobe(q.get("nprobe"))
                self.service.count("search")
                feats = self.service.encode_texts([text])
                self._json(200, self.service.search(feats, k, offset,
                                                    nprobe=nprobe))
            elif url.path == "/similar":
                image_id = int(q.get("id", "-1"))
                vec = self.service.stored_vector(image_id)
                if vec is None:
                    return self._bad(f"id {image_id} not found", 404)
                k, offset = _validated_k_offset(q.get("k", "50"),
                                                q.get("offset", "0"))
                nprobe = _validated_nprobe(q.get("nprobe"))
                self.service.count("similar")
                self._json(200, self.service.search(vec, k, offset,
                                                    nprobe=nprobe))
            else:
                self._bad("unknown endpoint", 404)
        except ColdShapeError as exc:
            self._cold(exc)
        except ValueError as exc:
            self._bad(f"bad parameter: {exc}")
        except Exception as exc:  # noqa: BLE001 — serve errors as JSON
            self._bad(f"{type(exc).__name__}: {exc}", 500)

    # -- POST ---------------------------------------------------------------
    def do_POST(self):
        url = urlparse(self.path)
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length < 0:
                return self._bad("bad Content-Length")
            if length > MAX_POST_BYTES:
                # never trust Content-Length into a read()
                return self._bad(
                    f"body exceeds {MAX_POST_BYTES} bytes", 413)
            payload = json.loads(self.rfile.read(length) or b"{}")
            if url.path == "/encode_text":
                texts = payload.get("texts")
                if not isinstance(texts, list) or not texts:
                    return self._bad("texts must be a non-empty list")
                self.service.count("encode_text")
                emb = self.service.encode_texts(texts)
                self._json(200, {"embeddings": emb.tolist()})
            elif url.path == "/search_vector":
                vec = payload.get("vector")
                k, _ = _validated_k_offset(payload.get("k", 50), 0)
                nprobe = _validated_nprobe(payload.get("nprobe"))
                arr = np.asarray(vec, dtype=np.float32).reshape(1, -1)
                dim = self.service.current_index().dim
                if arr.shape[1] != dim:
                    return self._bad(f"vector must have dim {dim}")
                self.service.count("search_vector")
                self._json(200, self.service.search(arr, k, nprobe=nprobe))
            elif url.path == "/encode_image":
                images = payload.get("images_b64")
                if (not isinstance(images, list) or not images
                        or not all(isinstance(t, str) for t in images)):
                    return self._bad("images_b64 must be a non-empty "
                                     "list of base64 strings")
                if len(images) > 64:
                    return self._bad("at most 64 images per request")
                self.service.count("encode_image")
                emb = self.service.encode_images_b64(images)
                self._json(200, {"embeddings": emb.tolist()})
            elif url.path == "/search_image":
                image = payload.get("image_b64")
                if not isinstance(image, str) or not image:
                    return self._bad("image_b64 must be a base64 string")
                k, _ = _validated_k_offset(payload.get("k", 50), 0)
                nprobe = _validated_nprobe(payload.get("nprobe"))
                self.service.count("search_image")
                feats = self.service.encode_images_b64([image])
                self._json(200, self.service.search(feats, k,
                                                    nprobe=nprobe))
            elif url.path == "/reload":
                self._json(200, self.service.reload())
            else:
                self._bad("unknown endpoint", 404)
        except ColdShapeError as exc:
            self._cold(exc)
        except (json.JSONDecodeError, TypeError, ValueError) as exc:
            self._bad(f"bad request: {exc}")
        except Exception as exc:  # noqa: BLE001
            self._bad(f"{type(exc).__name__}: {exc}", 500)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="clipx-serve")
    common.add_model_flags(p)
    common.add_sharded_flag(p, "row-shard the corpus")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="build the kernels and the encoder and run every "
                        "reachable text, search and image shape in the "
                        "background at startup, answering 503 for a "
                        "family until it is warm")
    return p


class _Server(ThreadingHTTPServer):
    # socketserver's listen backlog of 5 drops connections under a
    # concurrent burst, the load the coalescer is built for
    request_queue_size = 128


def _warm(service: SearchService, manifest: list,
          stop: threading.Event) -> None:
    """The warm-up thread: text buckets, then the kernel libraries and the
    search Q buckets, then the image buckets, marking each family ready
    as it finishes (and every family on exit, whatever failed)."""
    from clipx_torch.runtime.device import resolve_device
    from clipx_torch.runtime.encoder import _TEXT_BUCKETS, _pick_bucket

    gate = service._warm_gate

    def mark(family):
        if gate is not None:
            gate.mark(family)

    def mark_key(key):
        if gate is not None:
            gate.mark_key(key)

    try:
        # every text bucket the text coalescer's fills of 1..cap reach
        enc = service.encoder()
        tcap = (service._text_co.cap
                if service._text_co is not None else 1)
        tns = [n for n in _TEXT_BUCKETS if n <= tcap]
        tns += [int(e["n"]) for e in manifest
                if e.get("family") == "text"
                and int(e.get("n", 0)) in _TEXT_BUCKETS
                and int(e["n"]) not in tns]
        for n in tns:
            if stop.is_set():
                break
            enc.encode_texts(["warmup"] * n)
            service.count("warmup_text_shapes")
            mark_key(("text", n))
        mark("text")
    except Exception:  # noqa: BLE001 — warm-up is best-effort
        pass
    try:
        if resolve_device(service.args.device).type == "cuda":
            # every kernel library, one nvcc per stale source at once:
            # after this no request waits on nvcc
            from clipx_torch.ops import _build

            _build.load_all()
        # every search Q bucket the coalescer can emit, for each k in
        # $CLIPX_SERVE_WARMUP_K (k rounds up to a power of two) and each
        # (k, nprobe) of the manifest
        cap = min(service._search_co.cap
                  if service._search_co is not None else 1, 16)
        ks = []
        for tok in os.environ.get("CLIPX_SERVE_WARMUP_K",
                                  "50,10").split(","):
            try:
                ks.append(max(1, min(int(tok), 1000)))
            except ValueError:
                pass
        pairs = [(k, None) for k in (ks or [50])]
        pairs += [(int(e["k"]), e.get("nprobe"))
                  for e in manifest
                  if e.get("family") == "search"
                  and (int(e["k"]), e.get("nprobe")) not in pairs
                  and 0 < int(e["k"]) <= 16384]
        q = 1
        while q <= cap and not stop.is_set():
            # a reader per bucket, like a live search: a /reload must not
            # write the corpus under it, and a rebuild's dropped corpus is
            # not kept alive across buckets
            service._begin_read(timeout=600.0)
            try:
                idx = service.current_index()
                supports = getattr(idx, "supports_nprobe", False)
                for k, np_ in pairs:
                    kw = ({"nprobe": np_}
                          if np_ is not None and supports else {})
                    idx.search(np.zeros((q, idx.dim), np.float32), k, **kw)
            finally:
                service._end_read()
            del idx
            service.count("warmup_search_shapes")
            q *= 2
        idx = service.current_index()
        supports = getattr(idx, "supports_nprobe", False)
        for k, np_ in pairs:
            mark_key(("search",) + tuple(idx.shape_key(
                k, np_ if supports else None)))
        del idx
        mark("search")
    except Exception:  # noqa: BLE001 — warm-up is best-effort
        pass
    try:
        # both image buckets a request reaches (encode_images_b64 chunks
        # to 1 and _IMG_CHUNK rows) and the manifest's
        enc = service.encoder()
        ins = [1, SearchService._IMG_CHUNK]
        ins += [int(e["n"]) for e in manifest
                if e.get("family") == "image"
                and 0 < int(e.get("n", 0)) <= enc.buckets[-1]
                and int(e["n"]) not in ins]
        for n in ins:
            if stop.is_set():
                break
            zero = np.zeros((n, enc.image_size, enc.image_size, 3),
                            np.uint8)
            enc.encode_images(zero)
            service.count("warmup_image_shapes")
            mark_key(("image", _pick_bucket(n, enc.buckets)))
        mark("image")
    except Exception:  # noqa: BLE001 — warm-up is best-effort
        pass
    finally:
        # never leave the gate closed: past this point a request pays at
        # most the lazy first use of --no-warmup
        if gate is not None:
            gate.mark_all()


def make_server(args, encoder=None) -> ThreadingHTTPServer:
    """The bound HTTP server (not yet serving) over a new SearchService;
    with --warmup the gate is attached and the warm-up thread started.
    ``encoder``: see SearchService."""
    service = SearchService(args, encoder=encoder)
    handler = type("BoundHandler", (Handler,), {"service": service})
    server = _Server((args.host, args.port), handler)
    if getattr(args, "warmup", False):
        guard_mode = os.environ.get("CLIPX_SERVE_COLD_GUARD",
                                    "on").lower()
        if guard_mode != "off":
            service._warm_gate = _WarmGate(
                retry_after=max(1, int(
                    os.environ.get("CLIPX_SERVE_RETRY_AFTER", "30"))),
                keep_armed=guard_mode != "warmup")
        stop = threading.Event()
        t = threading.Thread(
            target=_warm, args=(service, service._manifest_entries(), stop),
            daemon=True, name="clipx-warmup")
        t.start()
        # main() stops warm-up at the next shape and joins it before the
        # process exits
        server._warmup_stop = stop
        server._warmup_thread = t
    return server


def main(argv=None) -> int:
    args = build_parser().parse_args(argv if argv is not None
                                     else sys.argv[1:])
    common.check_device(args)
    if not os.path.exists(args.index):
        from clipx_torch.search import codes_io

        # a codes-only deployment boots from the codes file alone
        if not (codes_io.tier_of_name(args.corpus_dtype) is not None
                and os.path.exists(codes_io.codes_path(args.index))):
            print(f"No index found at {args.index!r} — run "
                  "build-index.py first.")
            return 1
    server = make_server(args)
    service = server.RequestHandlerClass.service
    # SIGTERM (what a supervisor sends) shuts down as cleanly as Ctrl-C.
    # shutdown() must run off the main thread: it waits for serve_forever,
    # which is parked under the signal handler's own frame
    signal.signal(
        signal.SIGTERM,
        lambda *_: threading.Thread(target=server.shutdown,
                                    daemon=True).start())
    print(f"clipx-serve on http://{args.host}:{server.server_address[1]} "
          f"({service.index.ntotal} vectors)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    # stop warm-up at its next shape and wait out the one in flight
    if getattr(server, "_warmup_stop", None) is not None:
        server._warmup_stop.set()
        server._warmup_thread.join(timeout=600.0)
    service.close()      # drain the coalescers: in-flight batches land
    service.env.close()  # waits out live store readers
    server.server_close()
    print("bye", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
