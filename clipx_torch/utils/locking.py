"""Single-writer indexer lock (the port's own copy of clipx.utils.locking).

The reference *documents* multi-writer corruption instead of preventing
it ("Running multiple instances of build-index.py in parallel may mess
things up", reference README Known issues). We prevent it: the indexer
takes a non-blocking flock on ``<env>/INDEXER_LOCK`` for its lifetime
and refuses to start when another indexer holds it. The
rebuild-repairs-everything property is kept regardless (phase 2 rebuilds
idx_db and the index from fn_db from scratch, reference:build-index.py:66-109).
"""

from __future__ import annotations

import fcntl
import os


class LockHeldError(RuntimeError):
    pass


class SingleWriterLock:
    def __init__(self, env_dir: str, name: str = "INDEXER_LOCK"):
        os.makedirs(env_dir, exist_ok=True)
        self.path = os.path.join(env_dir, name)
        self._fd: int | None = None

    def acquire(self) -> None:
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            os.close(fd)
            raise LockHeldError(
                f"another indexer already holds {self.path}; refusing to "
                "run two writers (the reference documents this as "
                "corruption — we prevent it)") from None
        self._fd = fd

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None

    def __enter__(self) -> "SingleWriterLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
