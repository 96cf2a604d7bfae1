"""Exact maximum-inner-product search on the device (the faiss replacement).

Counterpart of ``clipx/search/engine.py`` for an f32 corpus: the corpus
lives on the device as one (N_pad, D) tensor, and a search is one matmul
plus a two-level top-k (exact mode), or an int8 scan whose best segments
are rescored exactly in f32 (quant mode, which ``--search-mode auto`` picks
from 100k rows). Results are faiss-shaped ``(D, I)``: scores descending,
int64 ids, -1 past ``ntotal``.

Shapes follow clipx so both packages rank the same candidates the same
way: rows pad to the same buckets (padding masked to -inf), k rounds up to
a power of two, queries pad to the Q bucket. Every top-k is a stable
descending sort, so equal scores (the -inf padding above all) come out
lowest index first, as ``lax.top_k`` orders them.

Arithmetic: queries and corpus are f32 and matmuls run in full f32
(``torch.backends.cuda.matmul.allow_tf32`` must stay False, PyTorch's
default; the Encoder and this engine never enable it). The int8 scan must
be exact integer arithmetic, as clipx's int32-accumulated ``dot_general``
is: on CUDA it runs ``torch._int_mm`` (int8 x int8 -> int32); on the CPU an
f32 matmul of the codes, which is exact because every partial sum is an
integer below 127 * 127 * D < 2**24 for D <= 1040.

Not ported yet: bf16/int8/int4/pq storage, codes files, IVF, sharding.
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from clipx_torch.runtime.device import resolve_device

_MAGIC = b"CLIPXIDX1\n"
_MIN_BUCKET = 4096
_MAX_Q = 16
_MAX_K = 16384
_CHUNK_W = 8192
_SEG_W = 64


def clamp_k(k: int) -> int:
    return max(1, min(int(k), _MAX_K))


def _bucket_rows(n: int) -> int:
    """Row bucket >= n: powers of two up to 1M rows, then 512k steps."""
    b = _MIN_BUCKET
    while b < n and b < (1 << 20):
        b *= 2
    if b >= n:
        return b
    step = 1 << 19
    return -(-n // step) * step


def _bucket_k(k: int) -> int:
    b = 16
    while b < k:
        b *= 2
    return b


def _bucket_q(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, _MAX_Q)


def _pad_q(queries: np.ndarray) -> Tuple[np.ndarray, int]:
    nq = queries.shape[0]
    b = _bucket_q(nq)
    if b == nq:
        return queries, nq
    out = np.zeros((b, queries.shape[1]), queries.dtype)
    out[:nq] = queries
    return out, nq


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, descending, ties lowest index first
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _exact_topk_seg(scores: torch.Tensor, k: int):
    """Two-level segment top-k: the k segments with the largest maxima hold
    every element >= the k-th largest score; take the top k among them."""
    q, n = scores.shape
    segs = n // _SEG_W
    s3 = scores.reshape(q, segs, _SEG_W)
    kk = min(k, segs)
    _, seg_idx = top_k(s3.amax(dim=-1), kk)                # (Q, kk)
    cand = torch.gather(s3, 1, seg_idx[:, :, None].expand(q, kk, _SEG_W))
    d, ci = top_k(cand.reshape(q, kk * _SEG_W), k)
    seg_of = torch.gather(seg_idx, 1, ci // _SEG_W)
    return d, seg_of * _SEG_W + ci % _SEG_W


def _exact_topk(scores: torch.Tensor, k: int):
    q, n = scores.shape
    if n < 2 * _CHUNK_W or n % _CHUNK_W != 0 or k > _CHUNK_W:
        return top_k(scores, k)
    return _exact_topk_seg(scores, k)


def _search_exact(corpus: torch.Tensor, valid: int, queries: torch.Tensor,
                  k: int):
    scores = queries @ corpus.T
    scores[:, valid:] = float("-inf")
    return _exact_topk(scores, k)


# -- int8 scan + exact rescore ------------------------------------------------

def _quantize_device(corpus: torch.Tensor):
    """Symmetric per-row int8 quantization of the scan copy."""
    scales = corpus.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    codes = torch.clamp(torch.round(corpus / scales), -127, 127).to(
        torch.int8)
    return codes, scales[:, 0]


def _int8_scores(codes: torch.Tensor, q_codes: torch.Tensor) -> torch.Tensor:
    """Exact (N, Q) integer scores codes @ q_codes.T, as f32."""
    if codes.device.type == "cuda":
        q = q_codes.shape[0]
        qp = max(8, -(-q // 8) * 8)  # _int_mm wants a multiple of 8
        rhs = torch.zeros((codes.shape[1], qp), dtype=torch.int8,
                          device=codes.device)
        rhs[:, :q] = q_codes.T
        return torch._int_mm(codes, rhs)[:, :q].float()
    return codes.float() @ q_codes.float().T


def _search_int8_seg(codes: torch.Tensor, scales: torch.Tensor,
                     corpus: torch.Tensor, valid: int,
                     queries: torch.Tensor, k: int):
    """int8 scan -> per-segment max -> top-k segments -> exact f32 rescore
    of all their rows (clipx's ``_search_kernel_int8_seg``). The query's
    quantization scale is a positive per-query constant and cannot change
    its segment ranking, so it is dropped."""
    q_scale = queries.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    q_codes = torch.clamp(torch.round(queries / q_scale), -127, 127).to(
        torch.int8)
    approx = _int8_scores(codes, q_codes) * scales[:, None]      # (N, Q)
    approx[valid:] = float("-inf")
    nq = queries.shape[0]
    segmax = approx.reshape(-1, _SEG_W, nq).amax(dim=1)          # (segs, Q)
    s = min(k, segmax.shape[0])
    _, seg_idx = top_k(segmax.T, s)                              # (Q, s)
    corpus3 = corpus.reshape(-1, _SEG_W, corpus.shape[1])
    rows = corpus3[seg_idx]                                      # (Q,s,W,D)
    exact = torch.einsum("qd,qswd->qsw", queries, rows)
    gids = (seg_idx[:, :, None] * _SEG_W
            + torch.arange(_SEG_W, device=seg_idx.device)[None, None, :])
    exact = exact.masked_fill(gids >= valid, float("-inf"))
    d, sel = top_k(exact.reshape(nq, s * _SEG_W), k)
    return d, torch.gather(gids.reshape(nq, s * _SEG_W), 1, sel)


class VectorIndex:
    """Flat inner-product index over device-resident f32 vectors. Row i is
    external id i (the byte-sorted path rank the indexer assigns)."""

    def __init__(self, dim: int, quantized: bool = False, device=None):
        self.dim = dim
        self.quantized = quantized
        self.device = resolve_device(device)
        self.ntotal = 0
        self.nprobe = 32  # faiss-compatibility no-op (the REPL's 'p')
        self._corpus: Optional[torch.Tensor] = None   # (N_pad, dim) f32
        self._codes: Optional[torch.Tensor] = None    # int8 scan copy
        self._scales: Optional[torch.Tensor] = None

    @classmethod
    def from_vectors(cls, vectors, quantized: bool = False,
                     device=None) -> "VectorIndex":
        idx = cls(dim=vectors.shape[1], quantized=quantized, device=device)
        idx.add(vectors)
        return idx

    def add(self, vectors) -> None:
        """Append rows (a numpy array, or a tensor on any device); ids
        continue from the current ntotal. Appends write in place; growth
        re-pads to the next row bucket on the device."""
        if isinstance(vectors, torch.Tensor):
            rows = vectors.to(self.device, torch.float32)
        else:
            rows = torch.from_numpy(np.require(
                vectors, np.float32, ("C", "W"))).to(self.device)
        if rows.dim() != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) vectors, "
                             f"got {tuple(rows.shape)}")
        n_new = rows.shape[0]
        if n_new == 0:
            return
        need = self.ntotal + n_new
        if self._corpus is None or need > self._corpus.shape[0]:
            grown = torch.zeros((_bucket_rows(need), self.dim),
                                dtype=torch.float32, device=self.device)
            if self._corpus is not None:
                grown[: self.ntotal] = self._corpus[: self.ntotal]
            self._corpus = grown
        self._corpus[self.ntotal: need] = rows
        self.ntotal = need
        self._codes = None  # the int8 scan copy is rebuilt on next search

    def _ensure_codes(self) -> None:
        if self._codes is None:
            codes, self._scales = _quantize_device(self._corpus)
            # set last: a concurrent search (the REPL's warm-up thread)
            # that sees the codes also sees their scales
            self._codes = codes

    def search(self, queries: np.ndarray,
               k: int) -> Tuple[np.ndarray, np.ndarray]:
        """faiss-shaped search: (D, I), D (Q, k) float32 descending, I
        (Q, k) int64; slots past ntotal get id -1."""
        k = clamp_k(k)
        if self.ntotal == 0:
            q = np.atleast_2d(np.asarray(queries))
            return (np.full((q.shape[0], k), -np.inf, np.float32),
                    np.full((q.shape[0], k), -1, np.int64))
        queries = np.require(np.atleast_2d(queries), np.float32,
                             ("C", "W"))
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim} "
                "(is --model the one this index was built with?)")
        if queries.shape[0] > _MAX_Q:
            parts = [self.search(queries[i: i + _MAX_Q], k)
                     for i in range(0, queries.shape[0], _MAX_Q)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        queries, nq = _pad_q(queries)
        kk = min(_bucket_k(k), self._corpus.shape[0])
        with torch.inference_mode():
            qt = torch.from_numpy(queries).to(self.device)
            if self.quantized:
                self._ensure_codes()
                scores, ids = _search_int8_seg(
                    self._codes, self._scales, self._corpus, self.ntotal,
                    qt, kk)
            else:
                scores, ids = _search_exact(self._corpus, self.ntotal, qt,
                                            kk)
            scores = scores[:nq, :k].cpu().numpy()
            ids = ids[:nq, :k].to(torch.int64).cpu().numpy()
        ids[~np.isfinite(scores)] = -1
        if scores.shape[1] < k:  # tiny corpus, huge (clamped) k
            pad = k - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)),
                            constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return scores, ids

    def reconstruct(self, row: int) -> np.ndarray:
        if not (0 <= row < self.ntotal):
            raise IndexError(row)
        return self._corpus[row].cpu().numpy().copy()


# ---------------------------------------------------------------------------
# persistence: 'images.index', the same bytes as clipx's
# (magic, int64 ntotal, int64 dim, float32 rows)
# ---------------------------------------------------------------------------

class IndexWriter:
    """Streaming sidecar writer: rows flow host RAM -> disk in chunks, so
    the build phase needs no device corpus. Atomic: data lands in
    ``path + '.tmp'`` and renames into place on ``close()``."""

    def __init__(self, path: str, ntotal: int, dim: int):
        import hashlib

        if not (0 <= ntotal and 0 < dim <= 65536):
            raise ValueError(f"bad index shape ({ntotal}, {dim})")
        self._path = path
        self._tmp = path + ".tmp"
        self._dim = dim
        self._remaining = ntotal
        self._hash = hashlib.blake2b(digest_size=16)
        self.content_hash: Optional[bytes] = None  # set on close()
        self._f = open(self._tmp, "wb")
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<qq", ntotal, dim))

    def write(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self._dim:
            raise ValueError(f"expected (n, {self._dim}) rows, "
                             f"got {rows.shape}")
        if rows.shape[0] > self._remaining:
            raise ValueError(f"wrote past the declared ntotal "
                             f"({rows.shape[0]} rows, "
                             f"{self._remaining} remaining)")
        raw = rows.tobytes()
        self._hash.update(raw)
        self._f.write(raw)
        self._remaining -= rows.shape[0]

    def close(self) -> None:
        if self._remaining:
            self._f.close()
            os.unlink(self._tmp)
            raise ValueError(f"index incomplete: {self._remaining} of "
                             "the declared rows were never written")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self._path)
        self.content_hash = self._hash.digest()


def read_index_vectors(path: str) -> np.ndarray:
    """Parse the sidecar into a host (ntotal, dim) float32 array."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            hint = ""
            if magic[:2] in (b"Iw", b"IV", b"Ix", b"IF"):
                hint = (" (this looks like a faiss index from the "
                        "reference implementation — rerun build-index.py "
                        "to regenerate it from vectors.lmdb)")
            raise ValueError(f"{path!r} is not a clipx index file{hint}")
        ntotal, dim = struct.unpack("<qq", f.read(16))
        if not (0 <= ntotal <= 1_000_000_000 and 0 < dim <= 65536):
            raise ValueError(f"{path!r} header is corrupt "
                             f"(ntotal={ntotal}, dim={dim})")
        raw = f.read(ntotal * dim * 4)
        if len(raw) != ntotal * dim * 4:
            raise ValueError(f"{path!r} is truncated "
                             f"({len(raw)} of {ntotal * dim * 4} bytes)")
    return np.frombuffer(raw, dtype=np.float32).reshape(ntotal, dim)


def read_index(path: str, device=None) -> VectorIndex:
    return VectorIndex.from_vectors(read_index_vectors(path), device=device)
