"""Corpus-sharded inner-product search over a device mesh (``--sharded``).

Counterpart of ``clipx/parallel/mips.py``. The corpus is row-sharded over a
1-D ``"shard"`` mesh: shard j holds global rows [j * rows, (j + 1) * rows),
``rows`` from :func:`_shard_rows`, so global id = j * rows + local row, and
ids stay the byte-sorted path ranks the indexer assigns. Padding rows
(past ``ntotal``) are masked to -inf, so they never win.

A search queues each shard's local top-k on its device (the single-device
tiers' own bodies with a global row ``base``: an exact f32/bf16 scan, the
int8 scan with exact rescore, int8 and int4 storage, pq storage on the PQ
scan kernel), with no host synchronisation between shards, then gathers
the shards' (Q, k) candidates onto the first device in mesh order (across
processes: each process's, then ``all_gather`` in rank order) and merges
them with one top-k. Every top-k breaks ties lowest position first, so the
merge is clipx's ``lax.top_k`` over its shard-major ``all_gather``.

Each shard's tensors live on its device; rows are placed from the host a
chunk at a time (never the whole f32 corpus on a device first). ``add``
writes each shard's part of the delta in place; growth re-deals the rows
into larger shards device to device. The pq codes are logical (rows, M/2)
per shard (clipx's lane pairing is a TPU layout); only the logical rows per
shard are clipx's.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from clipx_torch.parallel import distributed
from clipx_torch.parallel.mesh import Mesh, make_mesh
from clipx_torch.runtime.device import full_f32
from clipx_torch.search.engine import (_INT4_CHUNK, _MAX_Q, DTYPES,
                                       _bucket_k, _bucket_rows,
                                       _dequant_rows_of, _float_rows_of,
                                       _int4_segscan, _int8_encode,
                                       _int8_segscan, _pad_len, _pad_q,
                                       _quantize_device, _search_exact,
                                       _to_device_rows, clamp_k,
                                       coded_center_enabled, corpus_center,
                                       corpus_rotation, quantize_rows_rotated,
                                       refuse_int8_element, rotate_rows,
                                       top_k)
from clipx_torch.search.pq import (_PQ_CHUNK, _PQ_PALLAS_CHUNK,
                                   _PQ_PALLAS_ONESHOT, _pq_encode, _pq_topk,
                                   subspaces)

AXIS = "shard"
# host rows a chunk of placement (256 MiB of f32 rows at D = 512)
_PLACE_STEP = 1 << 17


def shard_mesh(devices=None) -> Mesh:
    """A 1-D ``"shard"`` mesh over ``devices`` (default: every process's
    visible GPUs, in rank order)."""
    ranks = None
    if devices is None:
        devices, ranks = distributed.global_devices()
    return make_mesh({AXIS: len(devices)}, devices, ranks)


def _shard_rows(n: int, n_shards: int, int4: bool = False,
                pq: bool = False) -> int:
    """Rows per shard for n total rows: equal static shards, lane-aligned
    to 128. int4/pq shards that exceed one scan chunk must also be a
    chunk MULTIPLE (their kernels map the scan over fixed-size chunks:
    engine._int4_segscan / pq._pq_topk) — a shard row count like 2.25
    chunks would otherwise be unsliceable. (clipx's rule, to the row: it
    sets each shard's candidate count, and so which candidates survive.)"""
    rows = -(-max(n, 1) // n_shards)
    rows = max(128, -(-rows // 128) * 128)
    if pq and rows > 4096:
        # align to the scan tile so per-shard capacities keep the kernel
        # path, and to the capacity-scale chunk past the one-shot bound
        rows = -(-rows // 4096) * 4096
        if rows > _PQ_PALLAS_ONESHOT:
            rows = -(-rows // _PQ_PALLAS_CHUNK) * _PQ_PALLAS_CHUNK
    chunk = _INT4_CHUNK if int4 else _PQ_CHUNK if pq else None
    if chunk and rows > chunk:
        rows = -(-rows // chunk) * chunk
    return rows


def _pack_factor(half: int) -> int:
    """clipx's lane-pairing factor of a pq code row of ``half`` bytes. The
    port keeps logical rows; only clipx's growth rule for pq appends, which
    aligns the write to it, is kept (so capacities match clipx's)."""
    pf = 1
    while half * pf * 2 <= 128:
        pf *= 2
    return pf


def _merge_across_shards(parts, k: int, mesh: Mesh):
    """The shards' (Q, c) (scores, global ids) side by side on the first
    local device in mesh order (then every process's, in rank order), and
    their top k: clipx's all_gather + lax.top_k."""
    dev = parts[0][0].device
    d = torch.cat([p[0].to(dev) for p in parts], dim=1)
    i = torch.cat([p[1].to(dev) for p in parts], dim=1)
    if mesh.process_group:
        d, i = distributed.all_gather_cols(d), distributed.all_gather_cols(i)
    dd, sel = top_k(d, k)
    return dd, torch.gather(i, 1, sel)


def _local_topk(index, j: int, q: torch.Tensor, k: int):
    """Shard ``j``'s (Q, k) scores and global ids: the single-device body of
    the index's tier with this shard's global row base."""
    base = index._local[j] * index._rows
    valid = index.ntotal
    if index.pq_storage:
        return _pq_topk(index._codes[j], index._pq.device(q.device), valid,
                        q, k, base=base)
    if index.int4_storage:
        return _int4_segscan(index._codes[j], index._scales[j], valid, q, k,
                             base=base)
    if index.int8_storage:
        codes, scales = index._codes[j], index._scales[j]
        return _int8_segscan(codes, scales, valid, q, k,
                             _dequant_rows_of(codes, scales), base=base)
    corpus = index._corpus[j]
    if index.quantized:
        return _int8_segscan(index._codes[j], index._scales[j], valid, q, k,
                             _float_rows_of(corpus), base=base)
    d, li = _search_exact(corpus, min(max(valid - base, 0), corpus.shape[0]),
                          q, k)
    return d, li + base


class ShardedVectorIndex:
    """Flat inner-product search with the corpus row-sharded over a 1-D
    ``"shard"`` mesh; the same contract as ``engine.VectorIndex`` (faiss's
    (D, I), -1 past ntotal), so a CLI can take either. ``dtype`` is the
    storage tier: "f32", "bf16", "int8", "int4" or "pq"."""

    def __init__(self, vectors: np.ndarray, mesh: Optional[Mesh] = None,
                 dtype: str = "f32", quantized: bool = False):
        if dtype not in DTYPES:
            raise ValueError(f"unknown corpus dtype {dtype!r} "
                             f"(one of {', '.join(DTYPES)})")
        if mesh is None:
            mesh = shard_mesh()
        if AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a {AXIS!r} axis")
        if len(mesh.axis_names) != 1:
            raise ValueError(f"a sharded index takes a 1-D {AXIS!r} mesh, "
                             f"got {mesh.shape}")
        self.mesh = mesh
        self.n_shards = mesh.shape[AXIS]
        self._local = mesh.local_positions()   # this process's shards
        self.devices = [mesh.devices[j] for j in self._local]
        self.device = self.devices[0]
        self.dtype = dtype
        # coded storage: the codes ARE the corpus, the scan is always
        # quantized and candidates rescore from dequantized rows
        self.pq_storage = dtype == "pq"
        self.int4_storage = dtype == "int4"
        self.int8_storage = dtype == "int8"
        self.quantized = True if self.coded_storage else quantized
        self.nprobe = 32  # faiss-compatibility no-op (the REPL's 'p')
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.ntotal, self.dim = vectors.shape
        if self.int4_storage and self.dim % 2:
            raise ValueError(f"int4 storage needs an even dim, "
                             f"got {self.dim}")
        if self.pq_storage:
            self._code_dim = subspaces(self.dim) // 2  # packed bytes
        else:
            self._code_dim = (self.dim // 2 if self.int4_storage
                              else self.dim)
        self._rows = 0  # rows a shard (logical)
        # one tensor a local shard, in mesh order
        self._corpus: Optional[List[torch.Tensor]] = None
        self._codes: Optional[List[torch.Tensor]] = None
        self._scales: Optional[List[torch.Tensor]] = None
        self._pq = None  # PQCodebook, trained on the first add
        self._rot = corpus_rotation(self.dim) if self.coded_storage else None
        self._center: Optional[np.ndarray] = None
        # concurrent first searches quantize the scan copy once
        self._codes_lock = threading.Lock()
        if self.pq_storage:
            if self.ntotal:  # the first add trains the codebooks
                self.ntotal = 0
                self.add(vectors)
            return
        if self.coded_storage:
            # placed even when empty (clipx's order): an index built empty
            # has no centre, and its adds quantize the raw rows
            if self.ntotal and coded_center_enabled():
                self._center = corpus_center(vectors, self._rot)
            self._place_codes(*quantize_rows_rotated(
                vectors, self._rot, self.int4_storage, center=self._center))
            return
        self._rows = _shard_rows(self.ntotal, self.n_shards)
        self._corpus = self._place(vectors, self._rows, self._store_dtype())

    @property
    def coded_storage(self) -> bool:
        """True when the quantized codes ARE the corpus (int8/int4/pq)."""
        return self.int8_storage or self.int4_storage or self.pq_storage

    def _store_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bf16" else torch.float32

    @classmethod
    def from_codes(cls, payload: dict,
                   mesh: Optional[Mesh] = None) -> "ShardedVectorIndex":
        """Place a loaded ``<index>.codes`` payload (``search/codes_io.py``)
        across the mesh without reading, quantizing or training from f32:
        the upload is the coded bytes, each shard's rows from the host a
        chunk at a time."""
        from clipx_torch.search.pq import PQCodebook

        tier = payload["tier"]
        idx = cls(np.zeros((0, payload["dim"]), np.float32), mesh=mesh,
                  dtype=tier)
        idx._code_dim = payload["code_dim"]  # the file's width wins
        if payload.get("rot_matrix") is not None:
            idx._rot = payload["rot_matrix"]  # trained OPQ rotation
        idx._center = payload.get("center")  # centered int8/int4 codes
        if payload["ntotal"] == 0:
            return idx
        if tier == "pq":
            idx._pq = PQCodebook(payload["centroids"])
            idx._place_codes(payload["codes"], None, pq=True)
        else:
            idx._place_codes(payload["codes"], payload["scales"])
        idx.ntotal = payload["ntotal"]
        return idx

    # -- placement and growth ---------------------------------------------------
    def _place(self, host, rows: int, dtype: torch.dtype, fill=0.0
               ) -> List[torch.Tensor]:
        """One (rows, ...) tensor a local shard, filled with ``fill``, shard
        j's head holding host rows [j * rows, (j + 1) * rows)."""
        out = []
        for j, dev in zip(self._local, self.devices):
            t = torch.full((rows,) + tuple(host.shape[1:]), fill,
                           dtype=dtype, device=dev)
            part = host[j * rows: (j + 1) * rows]
            if len(part):
                _to_device_rows(t, part, _PLACE_STEP)
            out.append(t)
        return out

    def _place_codes(self, codes: np.ndarray, scales: Optional[np.ndarray],
                     pq: bool = False) -> None:
        self._rows = _shard_rows(codes.shape[0], self.n_shards,
                                 self.int4_storage, pq)
        self._codes = self._place(codes, self._rows, torch.int8)
        if scales is not None:
            self._scales = self._place(scales, self._rows, torch.float32,
                                       1e-12)

    def _write(self, tensors: List[torch.Tensor], host: np.ndarray,
               start: int) -> None:
        """Host rows at global rows [start, start + len(host)), each local
        shard its part."""
        rows = self._rows
        for t, j in zip(tensors, self._local):
            lo = max(start, j * rows)
            hi = min(start + len(host), (j + 1) * rows)
            if lo < hi:
                t[lo - j * rows: hi - j * rows] = torch.from_numpy(
                    np.array(host[lo - start: hi - start])).to(t.device)

    def _regrow(self, old: List[torch.Tensor], rows: int,
                fill=0.0) -> List[torch.Tensor]:
        """The same global rows re-dealt into shards of ``rows``, device to
        device: new shard i takes global rows [i * rows, (i + 1) * rows)
        from whichever old shards held them. ``old`` is emptied as its
        shards are used up, so (if the caller held the only other
        reference) the devices hold about one corpus plus one shard."""
        was = self._rows
        tail, dtype = tuple(old[0].shape[1:]), old[0].dtype
        out = []
        for i, dev in zip(self._local, self.devices):
            t = torch.full((rows,) + tail, fill, dtype=dtype, device=dev)
            for pos, j in enumerate(self._local):
                lo = max(i * rows, j * was)
                hi = min((i + 1) * rows, (j + 1) * was)
                if lo < hi:
                    t[lo - i * rows: hi - i * rows] = old[pos][
                        lo - j * was: hi - j * was].to(dev)
                if (j + 1) * was <= (i + 1) * rows:
                    old[pos] = None  # every row of it is placed
            out.append(t)
        return out

    def _grow(self, need: int) -> None:
        """Re-pad to the row bucket of ``need`` (as the single-device index
        grows), re-dealing rows across shards on the devices: valid rows
        keep their global ids."""
        if self.mesh.multi_process:
            raise ValueError("a sharded index spread over several processes "
                             "cannot grow: its rows would cross processes; "
                             "rebuild it from all the rows")
        rows = _shard_rows(_bucket_rows(need), self.n_shards,
                           self.int4_storage, self.pq_storage)
        if self.coded_storage:
            old, self._codes = self._codes, None
            self._codes = self._regrow(old, rows)
            if self._scales is not None:
                old, self._scales = self._scales, None
                self._scales = self._regrow(old, rows, 1e-12)
        else:
            old, self._corpus = self._corpus, None
            self._codes = None  # the int8 scan copy is rebuilt lazily
            self._scales = None
            self._corpus = self._regrow(old, rows)
        self._rows = rows

    def add(self, vectors: np.ndarray) -> None:
        """Append rows in place; ids continue from ntotal. The HTTP
        service's incremental reload uses this: only the delta crosses to
        the devices. Appends pad their length to a power of two >= 128 and
        grow when the padded update does not fit (clipx's rule: capacities,
        rows per shard and so results match clipx's)."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) vectors, "
                             f"got {vectors.shape}")
        n_new = vectors.shape[0]
        if n_new == 0:
            return
        cap = self._rows * self.n_shards
        if self.pq_storage:
            codes, scales = _pq_encode(self, vectors), None
        elif self.coded_storage:
            codes, scales = _int8_encode(self, vectors)
        if self.coded_storage and self._codes is None:
            self._place_codes(codes, scales, self.pq_storage)
            self.ntotal = n_new
            return
        need = self.ntotal + _pad_len(n_new)
        if self.pq_storage:
            # clipx writes whole lane-paired rows from the pf-aligned base
            pf = _pack_factor(self._code_dim)
            prefix = self.ntotal % pf
            need = self.ntotal - prefix + _pad_len(n_new + prefix)
        if need > cap:
            self._grow(need)
        if self.coded_storage:
            self._write(self._codes, codes, self.ntotal)
            if scales is not None:
                self._write(self._scales, scales, self.ntotal)
        else:
            self._write(self._corpus, vectors, self.ntotal)
            self._codes = None  # the int8 scan copy is rebuilt lazily
            self._scales = None
        self.ntotal += n_new

    def _ensure_codes(self) -> None:
        if self._codes is not None:
            return
        with self._codes_lock:
            if self._codes is None:
                codes, scales = zip(*[_quantize_device(c)
                                      for c in self._corpus])
                # set last: a search that sees the codes without the lock
                # also sees their scales
                self._scales = list(scales)
                self._codes = list(codes)

    # -- search ---------------------------------------------------------------
    def shape_key(self, k: int, nprobe=None) -> tuple:
        """The request-dependent shape of a k-row search (the HTTP
        service's cold-shape gate): the k bucket, as ``VectorIndex``'s."""
        return (_bucket_k(clamp_k(k)),)

    def search(self, queries: np.ndarray,
               k: int) -> Tuple[np.ndarray, np.ndarray]:
        """faiss-shaped (D, I): (Q, k) f32 scores descending, int64 global
        ids, -1 past ntotal."""
        queries = np.require(np.atleast_2d(queries), np.float32, ("C", "W"))
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim} "
                "(is --model the one this index was built with?)")
        k = clamp_k(k)
        if self.ntotal == 0:
            return (np.full((queries.shape[0], k), -np.inf, np.float32),
                    np.full((queries.shape[0], k), -1, np.int64))
        if queries.shape[0] > _MAX_Q:
            parts = [self.search(queries[i: i + _MAX_Q], k)
                     for i in range(0, queries.shape[0], _MAX_Q)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        queries = rotate_rows(queries, self._rot)  # match rotated codes
        queries, nq = _pad_q(queries)
        kk = min(_bucket_k(k), self._rows)
        # merge over the gathered n_shards * kk pool: when k exceeds the
        # rows of a shard every shard still gives its whole list
        merge_k = min(_bucket_k(k), self.n_shards * kk)
        if self.quantized and not self.coded_storage:
            refuse_int8_element()
            self._ensure_codes()
        with torch.inference_mode(), full_f32(self.device):
            on = {}
            parts = []
            for j, dev in enumerate(self.devices):
                if dev not in on:
                    on[dev] = torch.from_numpy(queries).to(dev)
                parts.append(_local_topk(self, j, on[dev], kk))
            d, i = _merge_across_shards(parts, merge_k, self.mesh)
            d = d[:nq, :k].cpu().numpy()
            i = i[:nq, :k].to(torch.int64).cpu().numpy()
        if self._center is not None:
            # centered codes scored the residual: add the exact q·mean back
            d = d + (queries[:nq] @ self._center)[:, None]
        i[~np.isfinite(d)] = -1
        if d.shape[1] < k:  # k exceeds the gathered pool
            pad = k - d.shape[1]
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=-np.inf)
            i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
        return d, i
