"""Capture and replay of CUDA graphs, for a forward the port repeats at a
few fixed shapes whose eager launches would leave the card idle: the
Encoder's text tower and ``VectorIndex``'s flat pq search.

A ``CudaGraphs`` holds one owner's graphs, one a key. ``run`` captures a
key's graph at its first use, after one eager pass on the owner's side
stream (which builds cuBLAS's workspace and warms the allocator), into
the owner's one memory pool, with ``capture_error_mode="thread_local"`` so
other threads' launches do not abort it. One lock serialises the copy of
the input into the graph's static buffer, the replay and the caller's
read-back of the static output, so threads may run at once. A key whose
capture raises runs eagerly for good, with a note on stderr; if no other
graph of the owner is live, the failed graph was the pool's only user and
the pool is retired, so the next capture takes a new one.

Counts (``ops/_launch.py``'s ``FORWARD_COUNTS``): ``<family>_graph`` one a
replay, which also adds the kernel launches its capture recorded, and
``<family>_eager`` one an eager forward, the pass before a capture
included.
"""

from __future__ import annotations

import sys
import threading
from types import MappingProxyType
from typing import Callable, Hashable, Mapping, NamedTuple, Optional

import torch

from clipx_torch.ops import _launch


class _Graph(NamedTuple):
    """A captured forward: its static input and output, and what one
    replay adds to the counts."""

    graph: "torch.cuda.CUDAGraph"
    input: torch.Tensor
    output: object
    counts: dict


class CudaGraphs:
    """One owner's graphs of ``family``'s forward on ``device``; the
    failure note names a key by ``subject(key)``."""

    def __init__(self, device: torch.device, family: str,
                 subject: Callable[[Hashable], str]):
        self.device = device
        self.graph_count = f"{family}_graph"
        self.eager_count = f"{family}_eager"
        if not {self.graph_count, self.eager_count} <= set(
                _launch.FORWARD_COUNTS):
            raise ValueError(f"no forward counts for {family!r} in "
                             "ops/_launch.py's FORWARD_COUNTS")
        self._subject = subject
        # key -> _Graph, or None where the capture failed; the pool and the
        # side stream are made at the first capture
        self._graphs: dict = {}
        self._pool = self._stream = None
        self._lock = threading.Lock()

    @property
    def graphs(self) -> Mapping[Hashable, Optional[_Graph]]:
        return MappingProxyType(self._graphs)

    def run(self, key: Hashable, host: torch.Tensor,
            fn: Callable[[torch.Tensor], object],
            read: Callable[[object], object]):
        """``read`` of ``fn``'s output on ``host`` (pinned, at the key's
        shape): from a replay of the key's graph, with ``read`` under the
        lock, or eagerly where the key's capture failed."""
        with torch.cuda.device(self.device):
            with self._lock:
                if key not in self._graphs:
                    self._graphs[key] = self._captured(key, host, fn)
                g = self._graphs[key]
                if g is not None:
                    g.input.copy_(host, non_blocking=True)
                    g.graph.replay()
                    got = read(g.output)
            if g is None:
                return self.eager(host, fn, read)
        _launch.count(g.counts)
        return got

    def eager(self, host: torch.Tensor, fn, read):
        """``read`` of ``fn``'s output on ``host``, run eagerly."""
        got = read(fn(host.to(self.device)))
        _launch.count({self.eager_count: 1})
        return got

    def clear(self) -> None:
        """Forget every graph and retire the pool: the next run of a key
        captures anew."""
        with self._lock:
            self._graphs.clear()
            self._pool = None

    def _captured(self, key, host: torch.Tensor, fn) -> Optional[_Graph]:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(stream):
                static = torch.empty(host.shape, dtype=host.dtype,
                                     device=self.device)
                static.copy_(host, non_blocking=True)
                fn(static)
                _launch.count({self.eager_count: 1})
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = torch.cuda.CUDAGraph()
                with _launch.capturing() as launches:
                    graph.capture_begin(pool=self._pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = fn(static)
                    finally:
                        graph.capture_end()
            return _Graph(graph, static, out,
                          dict(launches, **{self.graph_count: 1}))
        except Exception as exc:  # noqa: BLE001 — the key runs eagerly
            print(f"({self._subject(key)} runs eagerly: its CUDA graph "
                  f"capture failed: {exc})", file=sys.stderr)
            if not any(self._graphs.values()):
                self._pool = None
            return None
        finally:
            torch.cuda.current_stream(self.device).wait_stream(stream)
