"""ctypes binding to the native key-value store (py-lmdb-shaped API).

The port's own copy of ``clipx/store/kv.py`` with its own copy of the
native source (``clipx_torch/store/native/kvstore.cpp``), built into this
package's directory: the on-disk format is the same, so a ``vectors.lmdb``
written by either package opens in the other.

The surface mirrors the subset of py-lmdb the reference uses
(reference:build-index.py:22-24,36-44,51,60-61,66-90 and
reference:query-index.py:25-27,92-95,117-118):

    env = open_env('vectors.lmdb', map_size=..., max_dbs=4)
    fn_db = env.open_db(b"fn_db")
    with env.begin(db=fn_db, write=True) as txn:
        txn.get(key); txn.put(key, value); txn.stat()['entries']
        txn.delete(key)
        for key, value in txn.cursor(): ...

so the CLI layer reads like the reference contract. ``map_size`` and
``max_dbs`` are accepted for signature compatibility and ignored — the
native store grows as needed and has no database cap.

Semantics note vs py-lmdb: ``get`` inside a write transaction sees that
transaction's own pending writes (read-your-writes), but *cursors*
iterate only committed state — no clipx code opens a cursor over keys
it is mutating in the same transaction.

The shared library is compiled from clipx_torch/store/native/kvstore.cpp on
first use (g++ is part of the toolchain); a build lock makes concurrent
first-use safe.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
import time
from typing import Iterator, Optional, Tuple

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libclipxkv.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "kvstore.cpp")

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> None:
    # compile to a temp file and atomically rename: the linker streams
    # its output in place, so building straight to _LIB_PATH would let
    # a concurrent process dlopen a half-written .so
    tmp = _LIB_PATH + f".build.{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", _SRC_PATH,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)):
            # cross-PROCESS build exclusion (the in-process _lib_lock
            # cannot stop build-index and serve racing a first-use
            # compile); paired with the tmp+rename above, a loser of the
            # race just re-checks and loads the winner's library
            import fcntl
            with open(_LIB_PATH + ".buildlock", "w") as lf:
                fcntl.flock(lf, fcntl.LOCK_EX)
                if (not os.path.exists(_LIB_PATH)
                        or os.path.getmtime(_LIB_PATH)
                        < os.path.getmtime(_SRC_PATH)):
                    _build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.cxkv_open.restype = ctypes.c_void_p
        lib.cxkv_open.argtypes = [ctypes.c_char_p]
        lib.cxkv_close.argtypes = [ctypes.c_void_p]
        lib.cxkv_db.restype = ctypes.c_int
        lib.cxkv_db.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.cxkv_entries.restype = ctypes.c_uint64
        lib.cxkv_entries.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.cxkv_txn_begin.restype = ctypes.c_void_p
        lib.cxkv_txn_begin.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.cxkv_txn_commit.restype = ctypes.c_int
        lib.cxkv_txn_commit.argtypes = [ctypes.c_void_p]
        lib.cxkv_txn_abort.argtypes = [ctypes.c_void_p]
        lib.cxkv_del.restype = ctypes.c_int
        lib.cxkv_del.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_size_t]
        lib.cxkv_put.restype = ctypes.c_int
        lib.cxkv_put.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_char_p, ctypes.c_size_t]
        lib.cxkv_get.restype = ctypes.POINTER(ctypes.c_char)
        lib.cxkv_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.POINTER(ctypes.c_size_t)]
        lib.cxkv_cursor_open.restype = ctypes.c_void_p
        lib.cxkv_cursor_open.argtypes = [ctypes.c_void_p, ctypes.c_int]
        ptr_t = ctypes.POINTER(ctypes.POINTER(ctypes.c_char))
        len_t = ctypes.POINTER(ctypes.c_size_t)
        for fn in (lib.cxkv_cursor_first, lib.cxkv_cursor_next):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ptr_t, len_t, ptr_t, len_t]
        lib.cxkv_cursor_close.argtypes = [ctypes.c_void_p]
        lib.cxkv_error.restype = ctypes.c_char_p
        lib.cxkv_error.argtypes = [ctypes.c_void_p]
        lib.cxkv_refresh.restype = ctypes.c_int
        lib.cxkv_refresh.argtypes = [ctypes.c_void_p]
        lib.cxkv_compact.restype = ctypes.c_int
        lib.cxkv_compact.argtypes = [ctypes.c_void_p]
        lib.cxkv_sync.restype = ctypes.c_int
        lib.cxkv_sync.argtypes = [ctypes.c_void_p]
        lib.cxkv_generation.restype = ctypes.c_uint64
        lib.cxkv_generation.argtypes = [ctypes.c_void_p]
        lib.cxkv_overlay_bytes.restype = ctypes.c_uint64
        lib.cxkv_overlay_bytes.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _as_bytes(x) -> bytes:
    if isinstance(x, bytes):
        return x
    if isinstance(x, str):
        return x.encode()
    return bytes(x)


class Error(Exception):
    pass


class Cursor:
    """Iterates (key, value) byte pairs in lexicographic key order."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle
        self._pending = None  # the item first() positioned on

    def _step(self, fn) -> Optional[Tuple[bytes, bytes]]:
        if not self._h:
            # a NULL handle into the native call is a segfault, not an
            # exception — match py-lmdb, which raises on finished objects
            raise Error("cursor is closed")
        k = ctypes.POINTER(ctypes.c_char)()
        v = ctypes.POINTER(ctypes.c_char)()
        klen = ctypes.c_size_t()
        vlen = ctypes.c_size_t()
        ok = fn(self._h, ctypes.byref(k), ctypes.byref(klen),
                ctypes.byref(v), ctypes.byref(vlen))
        if not ok:
            return None
        return (ctypes.string_at(k, klen.value),
                ctypes.string_at(v, vlen.value))

    def first(self) -> bool:
        """Position on the first item; the next iteration starts with it.
        False when the database is empty."""
        item = self._step(self._lib.cxkv_cursor_first)
        if item is None:
            return False
        self._pending = item
        return True

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            yield pending
        while True:
            item = self._step(self._lib.cxkv_cursor_next)
            if item is None:
                return
            yield item

    def close(self) -> None:
        if self._h:
            self._lib.cxkv_cursor_close(self._h)
            self._h = None


class Transaction:
    def __init__(self, env: "Environment", db: Optional[int], write: bool):
        self._env = env
        self._lib = env._lib
        self._default_db = env._main_db if db is None else db
        env._txn_enter()
        self._h = self._lib.cxkv_txn_begin(env._h, 1 if write else 0)
        self._write = write
        self._cursors = []

    def _check(self) -> None:
        # passing a NULL/stale handle into the native library segfaults
        # the interpreter; py-lmdb raises on finished objects — so do we
        if not self._h:
            raise Error("transaction is finished (committed or aborted)")
        if not self._env._h:
            raise Error("environment is closed")

    # -- py-lmdb-shaped API -------------------------------------------------
    def get(self, key, default=None, db: Optional[int] = None):
        self._check()
        key = _as_bytes(key)
        vlen = ctypes.c_size_t()
        ptr = self._lib.cxkv_get(self._h, self._db(db), key, len(key),
                                 ctypes.byref(vlen))
        if not ptr:
            return default
        return ctypes.string_at(ptr, vlen.value)

    def put(self, key, value, db: Optional[int] = None, dupdata: bool = True,
            overwrite: bool = True) -> bool:
        # dupdata/overwrite accepted for reference-signature compatibility
        # (reference:build-index.py:88); the store is always last-write-wins.
        self._check()
        key, value = _as_bytes(key), _as_bytes(value)
        if not overwrite and self.get(key, db=db) is not None:
            return False
        rc = self._lib.cxkv_put(self._h, self._db(db), key, len(key),
                                value, len(value))
        if rc != 0:
            raise Error("put on read-only/finished transaction "
                        "or invalid db handle")
        return True

    def delete(self, key, db: Optional[int] = None) -> bool:
        """Remove ``key``; True if it was there (this transaction's own
        writes included)."""
        self._check()
        key = _as_bytes(key)
        existed = self.get(key, db=db) is not None
        rc = self._lib.cxkv_del(self._h, self._db(db), key, len(key))
        if rc != 0:
            raise Error("delete on read-only/finished transaction "
                        "or invalid db handle")
        return existed

    def stat(self, db: Optional[int] = None) -> dict:
        self._check()
        return {"entries": int(self._lib.cxkv_entries(self._env._h,
                                                      self._db(db)))}

    def cursor(self, db: Optional[int] = None) -> Cursor:
        self._check()
        cur = Cursor(self._lib, self._lib.cxkv_cursor_open(self._h,
                                                           self._db(db)))
        self._cursors.append(cur)
        return cur

    def commit(self) -> None:
        self._close_cursors()
        if self._h:
            rc = self._lib.cxkv_txn_commit(self._h)
            self._h = None
            # read the native error detail BEFORE _txn_exit(): dropping
            # the live-txn count can wake a blocked Environment.close(),
            # which frees the env handle — cxkv_error afterwards would be
            # a use-after-free (or a NULL deref once _h is swapped out)
            detail = ""
            if rc != 0:
                detail = (self._lib.cxkv_error(self._env._h) or b"").decode(
                    errors="replace")
            self._env._txn_exit()
            if rc != 0:
                raise Error(f"commit failed (rc={rc})"
                            + (f": {detail}" if detail else ""))

    def abort(self) -> None:
        self._close_cursors()
        if self._h:
            self._lib.cxkv_txn_abort(self._h)
            self._h = None
            self._env._txn_exit()

    # -- context manager ------------------------------------------------------
    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.commit()
        else:
            self.abort()

    # -- helpers ---------------------------------------------------------------
    def _db(self, db: Optional[int]) -> int:
        return self._default_db if db is None else db

    def _close_cursors(self) -> None:
        for cur in self._cursors:
            cur.close()
        self._cursors.clear()


class Environment:
    """One storage environment (a directory), holding named sub-databases."""

    def __init__(self, path: str, map_size: int = 0, max_dbs: int = 0):
        del map_size, max_dbs  # compatibility only; the store grows as needed
        self._lib = _load()
        self._h = self._lib.cxkv_open(_as_bytes(path))
        if not self._h:
            raise Error(f"cannot open environment at {path!r}")
        self.path = path
        # live-transaction accounting so close() can wait for in-flight
        # readers instead of unmapping segments under them (observed as
        # a segfault when a serving thread raced env.close())
        self._txn_cv = threading.Condition()
        self._txn_live = 0
        self._closing = False
        # the unnamed "main" database, like lmdb's default db
        self._main_db = self._lib.cxkv_db(self._h, b"")

    def open_db(self, name) -> int:
        return self._lib.cxkv_db(self._h, _as_bytes(name))

    def begin(self, db: Optional[int] = None, write: bool = False) -> Transaction:
        return Transaction(self, db, write)

    def sync(self) -> None:
        """Flush the write-ahead log to the disk (``fdatasync``)."""
        self._lib.cxkv_sync(self._h)

    def refresh(self) -> None:
        """Fold in transactions committed by other processes (or other
        environments on the same path) since this one was opened or last
        refreshed: reads are otherwise a snapshot as of open."""
        rc = self._lib.cxkv_refresh(self._h)
        if rc != 0:
            raise Error(f"refresh failed (rc={rc})")

    def compact(self) -> None:
        """Rewrite the store with only its live records (a new segment
        generation; the maintenance tool's ``compact``)."""
        rc = self._lib.cxkv_compact(self._h)
        if rc != 0:
            raise Error(f"compact failed (rc={rc})")

    def generation(self) -> int:
        """Current segment generation (bumps on every compaction)."""
        return int(self._lib.cxkv_generation(self._h))

    def overlay_bytes(self) -> int:
        """Approximate RAM held by the write overlay (the memtable);
        bounded by $CLIPX_KV_MEMTABLE_MB: bulk ingests spill to a new
        sorted-segment generation instead of accumulating."""
        return int(self._lib.cxkv_overlay_bytes(self._h))

    def _txn_enter(self) -> None:
        with self._txn_cv:
            # refuse NEW transactions once close() starts waiting — each
            # cv.wait releases the lock, so without this gate a steady
            # reader load keeps _txn_live above zero until the timeout
            # and close() frees the native env under live readers
            if not self._h or self._closing:
                raise Error("environment is closed")
            self._txn_live += 1

    def _txn_exit(self) -> None:
        with self._txn_cv:
            self._txn_live -= 1
            if self._txn_live == 0:
                self._txn_cv.notify_all()

    def close(self, timeout: float = 10.0) -> None:
        """Close the environment. Waits up to ``timeout`` seconds for
        in-flight transactions (other threads mid-read) to finish —
        closing under a live reader would unmap the segment it is
        reading (LMDB documents the same hazard as undefined behavior;
        here it is a bounded wait plus a loud warning instead)."""
        with self._txn_cv:
            if not self._h:
                return
            self._closing = True  # _txn_enter refuses new txns from here
            deadline = time.monotonic() + timeout
            while self._txn_live > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    sys.stderr.write(
                        f"clipx_torch.store: closing {self.path!r} with "
                        f"{self._txn_live} transaction(s) still live "
                        f"after {timeout:.0f}s wait\n")
                    break
                self._txn_cv.wait(remaining)
            h, self._h = self._h, None
        self._lib.cxkv_close(h)

    def __enter__(self) -> "Environment":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def open_env(path: str, map_size: int = 0, max_dbs: int = 0) -> Environment:
    """py-lmdb's ``lmdb.open`` equivalent (reference:build-index.py:22)."""
    return Environment(path, map_size=map_size, max_dbs=max_dbs)
