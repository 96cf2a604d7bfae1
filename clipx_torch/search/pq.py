"""Product-quantized corpus storage (``--corpus-dtype pq``).

Counterpart of ``clipx/search/pq.py``. Dims split into M = D/dsub
subspaces; each subspace has a 16-entry k-means codebook, so a row is M
4-bit codes packed two per byte in the SPLIT layout (byte j = code j low
nibble | code j + M/2 high nibble). ``$CLIPX_PQ_DSUB`` picks 2 (default:
2 bits/dim, 128 B/row at D = 512) or 4 (1 bit/dim, 64 B/row).

Host side (numpy, the same code as clipx's, so codebooks, rotations and
codes match clipx's byte for byte): ``pack_codes4``, ``PQCodebook`` (seeded
Lloyd k-means, encode, decode), ``train_opq`` (the trained OPQ rotation)
and the knobs ``pq_dsub`` and ``opq_mode``.

Device side (torch): ``make_luts`` / ``quantized_luts`` build each query's
ADC table and its int8 quantization; ``_pq_topk`` scans the codes with the
PQ kernel (``ops/pq_scan.py``) against the int8 LUT, keeps each chunk's top
``4k`` candidates, merges them and rescores the survivors against the f32
LUT, so returned scores are the full-precision PQ scores. A chunk is as
many rows as the Q queries' f32 score block allows (``_scan_chunk``): the
whole capacity while Q x rows stays within ``_PQ_SCORE_BLOCK`` (every
capacity up to ``_PQ_PALLAS_ONESHOT`` rows at every Q bucket, 2^24 rows at
Q = 1), else the largest multiple of ``_PQ_PALLAS_CHUNK`` that divides it
and fits. Every top-k breaks ties lowest index first, so the candidates
equal those of clipx's XLA path. A flat index on the card replays
``_pq_topk`` from a captured CUDA graph (``VectorIndex.search``).

Layout: clipx lane-pairs the device code array (``pack_factor``,
``pair_rows_host``) because a TPU pads int8 rows to 128 lanes. That is a
TPU layout: the port stores codes as logical (N_pad, M/2) rows. The bytes
of ``<index>.codes`` are logical rows in both packages.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from clipx_torch.ops.pq_scan import pq_scan_scores
from clipx_torch.ops.pq_scan import unpack_codes4 as _unpack_codes4
from clipx_torch.search.engine import _exact_topk, _pad_len, top_k

PQ_K = 16              # centroids per subspace (4-bit codes)
PQ_RESCORE_MARGIN = 4  # f32-LUT-rescored candidates per requested k
_PQ_TRAIN_SAMPLE = 1 << 16
_PQ_ITERS = 15
_PQ_SEED = 0xC11B9
# clipx's scan chunking, kept as the port's placement rule: a capacity (or a
# shard, ``parallel/mips.py::_shard_rows``) past _PQ_PALLAS_ONESHOT rows is
# a multiple of _PQ_PALLAS_CHUNK rows, and a scan chunk is too
_PQ_PALLAS_ONESHOT = 1 << 21
_PQ_PALLAS_CHUNK = 1 << 19
# the f32 scores one scan chunk may write: 128 MiB, the (16, 2^21) block of
# clipx's one-shot bound at _MAX_Q, and the (1, 2^25) block at Q = 1
_PQ_SCORE_BLOCK = 1 << 25
# clipx's XLA scan chunk: the port scans in the chunks above, but a sharded
# index aligns its rows a shard to this too, as clipx's does
# (``parallel/mips.py::_shard_rows``)
_PQ_CHUNK = 1 << 16


def pq_dsub() -> int:
    """Dims per subspace for NEW codebooks ($CLIPX_PQ_DSUB): 2 or 4. An
    existing index keeps the width its codebooks were trained with."""
    v = os.environ.get("CLIPX_PQ_DSUB", "2")
    if v not in ("2", "4"):
        raise ValueError(f"CLIPX_PQ_DSUB must be 2 or 4, got {v!r}")
    return int(v)


def subspaces(dim: int, dsub: Optional[int] = None) -> int:
    dsub = pq_dsub() if dsub is None else dsub
    if dim % (2 * dsub):
        raise ValueError("pq storage needs dim % "
                         f"{2 * dsub} == 0, got {dim}")
    return dim // dsub


# -- packing (SPLIT layout, unsigned nibbles) ---------------------------------

def pack_codes4(codes: np.ndarray) -> np.ndarray:
    """(N, M) uint8 codes in [0, 16) -> (N, M/2) int8 packed, split layout:
    byte j = code j (low nibble) | code j + M/2 (high)."""
    m = codes.shape[1]
    lo = codes[:, : m // 2].astype(np.uint8)
    hi = codes[:, m // 2:].astype(np.uint8)
    return (lo | (hi << 4)).view(np.int8)


def unpack_codes4_host(packed: np.ndarray) -> np.ndarray:
    """numpy twin of the device unpack: (N, M/2) packed -> (N, M) uint8."""
    u = packed.view(np.uint8)
    return np.concatenate([u & 0x0F, u >> 4], axis=-1)


# -- codebooks -----------------------------------------------------------------

def _assign(x: np.ndarray, cent: np.ndarray) -> np.ndarray:
    """Nearest centroid per row: x (S, dsub), cent (K, dsub) -> (S,) uint8,
    argmin of ||c||^2 - 2 x.c."""
    g = x @ cent.T
    g *= -2.0
    g += (cent ** 2).sum(-1)
    return g.argmin(1).astype(np.uint8)


class PQCodebook:
    """Per-subspace 16-entry codebooks: centroids (M, 16, dsub) f32 in
    ROTATED space. The subspace width is whatever the codebook was trained
    with."""

    def __init__(self, centroids: np.ndarray):
        if (centroids.ndim != 3 or centroids.shape[1] != PQ_K
                or centroids.shape[2] not in (2, 4)):
            raise ValueError(f"bad codebook shape {centroids.shape}")
        self.centroids = np.ascontiguousarray(centroids, np.float32)
        self._device = {}

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    def device(self, device) -> torch.Tensor:
        """The centroids as a tensor on ``device`` (cached)."""
        key = str(device)
        if key not in self._device:
            self._device[key] = torch.tensor(self.centroids, device=device)
        return self._device[key]

    @classmethod
    def train(cls, rows: np.ndarray, sample: int = _PQ_TRAIN_SAMPLE,
              iters: int = _PQ_ITERS,
              rot: Optional[np.ndarray] = None) -> "PQCodebook":
        """Deterministic Lloyd k-means per subspace on a seeded sample of
        ``rows`` (which may be a sidecar memmap: only the sample is
        materialized), rotated by ``rot``."""
        n, d = rows.shape
        dsub = pq_dsub()
        m = subspaces(d, dsub)
        rng = np.random.default_rng(_PQ_SEED + d)
        if n > sample:
            x = np.ascontiguousarray(
                rows[rng.choice(n, sample, replace=False)], np.float32)
        else:
            x = np.ascontiguousarray(rows, np.float32)
        if rot is not None:
            x = x @ rot
        s = x.shape[0]
        xs = np.ascontiguousarray(
            x.reshape(s, m, dsub).transpose(1, 0, 2))      # (M, S, dsub)
        k_eff = min(PQ_K, s)
        init = rng.choice(s, k_eff, replace=False)
        cent = np.ascontiguousarray(xs[:, init])           # (M, k_eff, dsub)
        if k_eff < PQ_K:  # tiny corpus: duplicate centroids are harmless
            cent = np.concatenate(
                [cent, np.repeat(cent[:, :1], PQ_K - k_eff, axis=1)],
                axis=1)
        for _ in range(iters):
            for mi in range(m):
                assign = _assign(xs[mi], cent[mi])
                counts = np.bincount(assign, minlength=PQ_K)
                nz = counts > 0
                sums = np.stack(
                    [np.bincount(assign, weights=xs[mi, :, j],
                                 minlength=PQ_K) for j in range(dsub)],
                    axis=1)
                cent[mi][nz] = (sums[nz] / counts[nz, None]).astype(
                    np.float32)  # empty clusters keep their old centroid
        return cls(cent)

    def encode(self, rows: np.ndarray, chunk: int = 1 << 16,
               rot: Optional[np.ndarray] = None) -> np.ndarray:
        """(N, D) f32 rows -> (N, M/2) packed codes, nearest centroid per
        subspace; ``rot`` rotates rows chunk-wise."""
        rows = np.ascontiguousarray(rows, np.float32)
        n, d = rows.shape
        m, dsub = self.m, self.dsub
        if d != m * dsub:
            raise ValueError(f"codebook covers {m * dsub} dims, "
                             f"rows have {d}")
        out = np.empty((n, m // 2), np.int8)
        for i in range(0, n, chunk):
            b = rows[i: i + chunk]
            if rot is not None:
                b = b @ rot
            xs = np.ascontiguousarray(
                b.reshape(len(b), m, dsub).transpose(1, 0, 2))
            codes = np.empty((m, len(b)), np.uint8)
            for mi in range(m):
                codes[mi] = _assign(xs[mi], self.centroids[mi])
            out[i: i + len(b)] = pack_codes4(codes.T)
        return out

    def decode(self, packed: np.ndarray) -> np.ndarray:
        """(N, M/2) packed codes -> (N, D) rotated-space f32 rows."""
        codes = unpack_codes4_host(np.atleast_2d(packed))
        n, m = codes.shape
        rec = self.centroids[np.arange(m)[None, :], codes]  # (N, M, dsub)
        return rec.reshape(n, m * self.dsub).astype(np.float32)


def pq_residual_enabled() -> bool:
    """$CLIPX_PQ_RESIDUAL (IVF with pq storage only): 'on' (default) encodes
    each row's RESIDUAL against its segment centroid, faiss IndexIVFPQ's
    ``by_residual``; the coarse score q.cent is exact f32. 'off' encodes the
    raw rows with one global codebook."""
    return os.environ.get("CLIPX_PQ_RESIDUAL", "on").lower() not in (
        "off", "0", "false")


def opq_mode() -> str:
    """$CLIPX_PQ_OPQ: 'trained' (default, the alternating-minimization OPQ
    rotation) or 'fixed' (the seed-derived random rotation)."""
    v = os.environ.get("CLIPX_PQ_OPQ", "trained").lower()
    return v if v in ("trained", "fixed") else "trained"


_OPQ_ITERS = 10


def train_opq(rows: np.ndarray, rot0: Optional[np.ndarray],
              iters: int = _OPQ_ITERS
              ) -> Tuple[Optional[np.ndarray], "PQCodebook"]:
    """Trained OPQ rotation + codebooks: from the fixed rotation, alternate
    k-means codebooks under the current rotation with the orthogonal
    Procrustes update R = U V^T of X^T X_hat, on the codebook trainer's own
    seeded sample. Returns (R, codebook); keeps ``rot0`` when rotation is
    off, OPQ is 'fixed', or the corpus has fewer than 4*dim rows (a
    rotation from so few rows overfits their span)."""
    n, d = rows.shape
    if rot0 is None or opq_mode() == "fixed" or n < 4 * d:
        return rot0, PQCodebook.train(rows, rot=rot0)
    subspaces(d)  # validates divisibility up front
    rng = np.random.default_rng(_PQ_SEED + d)
    if n > _PQ_TRAIN_SAMPLE:
        x = np.ascontiguousarray(
            rows[rng.choice(n, _PQ_TRAIN_SAMPLE, replace=False)],
            np.float32)
    else:
        x = np.ascontiguousarray(rows, np.float32)
    r = np.ascontiguousarray(rot0, np.float32)
    for _ in range(iters):
        cb = PQCodebook.train(x, iters=5, rot=r)
        xr = x @ r
        codes = cb.encode(xr)
        xhat = cb.decode(codes)                      # (S, D) rotated
        u, _, vt = np.linalg.svd(x.T @ xhat)
        r = np.ascontiguousarray((u @ vt), np.float32)
    return r, PQCodebook.train(rows, rot=r)


# -- device side -------------------------------------------------------------

def make_luts(queries: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Per-query ADC tables: (Q, M, 16) f32, LUT[q, m, c] = the inner
    product of query block m with centroid c."""
    nq = queries.shape[0]
    m, _, dsub = centroids.shape
    qb = queries.reshape(nq, m, dsub)
    return torch.einsum("qmd,mkd->qmk", qb, centroids)


def quantized_luts(queries: torch.Tensor, centroids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lut, luti, scale): the flat (Q, M*16) f32 tables, their per-query
    int8 quantization for the scan, and the (Q, 1) f32 scale (dropped by
    flat PQ ranking: a positive per-query scale changes no ranking)."""
    nq = queries.shape[0]
    lut = make_luts(queries, centroids).reshape(nq, -1)
    scale = lut.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    luti = torch.clamp(torch.round(lut / scale), -127, 127).to(torch.int8)
    return lut, luti, scale


def _scan_chunk(n: int, nq: int) -> int:
    """Rows a scan chunk of ``_pq_topk`` covers, for ``nq`` queries over an
    ``n``-row capacity: all ``n`` while the (nq, n) f32 scores fit
    ``_PQ_SCORE_BLOCK``, else the largest multiple of ``_PQ_PALLAS_CHUNK``
    that divides ``n`` and fits (one fits every Q bucket: 16 x 2^19 is a
    quarter of the block)."""
    if nq * n <= _PQ_SCORE_BLOCK:
        return n
    if n % _PQ_PALLAS_CHUNK:
        raise ValueError(f"pq capacity {n} not a chunk multiple "
                         f"({_PQ_PALLAS_CHUNK}) — placement must pad to "
                         "engine._bucket_rows")
    units = n // _PQ_PALLAS_CHUNK
    fit = _PQ_SCORE_BLOCK // (nq * _PQ_PALLAS_CHUNK)
    return max(u for u in range(1, min(fit, units) + 1)
               if units % u == 0) * _PQ_PALLAS_CHUNK


def _pq_topk(packed: torch.Tensor, centroids: torch.Tensor, valid: int,
             queries: torch.Tensor, k: int, base: int = 0):
    """The PQ search: int8-LUT scan (``pq_scan_scores``) per chunk -> each
    chunk's top ``m_cand`` -> global merge -> f32-LUT rescore -> top k.
    ``packed`` is the (N_pad, M/2) logical code array. ``base`` is the
    global id of row 0 for sharded callers (``parallel/mips.py``), whose
    ``valid`` is global: a row is valid when base + row < valid, and ids
    come back global."""
    valid = max(valid - base, 0)
    half = centroids.shape[0] // 2
    n, width = packed.shape
    if width != half:
        raise ValueError(f"code width {width} != M/2 = {half}")
    nq = queries.shape[0]
    lut, luti, _ = quantized_luts(queries, centroids)       # (Q, M*16)
    lut_t = luti.T.contiguous()                             # (M*16, Q)
    chunk = _scan_chunk(n, nq)
    m_cand = min(PQ_RESCORE_MARGIN * k, chunk)

    def scan_chunk(start):
        approx = pq_scan_scores(packed[start: start + chunk], lut_t)
        if valid < start + chunk:
            approx[:, max(valid - start, 0):] = float("-inf")
        d, li = _exact_topk(approx, m_cand)                 # (Q, m)
        return d, li + start

    if n == chunk:
        _, cand = scan_chunk(0)
    else:
        parts = [scan_chunk(s) for s in range(0, n, chunk)]
        d_all = torch.cat([d for d, _ in parts], dim=1)     # chunk-major
        i_all = torch.cat([i for _, i in parts], dim=1)
        _, pos = _exact_topk(d_all, m_cand)
        cand = torch.gather(i_all, 1, pos)                  # (Q, m)

    # f32-LUT rescore of the candidates: exact PQ scores, the query-side
    # int8 rounding cancels (a gather of each code's entry, then the sum)
    codes = _unpack_codes4(packed[cand]).long()             # (Q, m, M)
    lut3 = lut.reshape(nq, 1, 2 * half, PQ_K).expand(nq, m_cand, -1, -1)
    exact = torch.gather(lut3, 3, codes[..., None])[..., 0].sum(dim=-1)
    exact = exact.masked_fill(cand >= valid, float("-inf"))
    dd, sel = top_k(exact, k)
    return dd, torch.gather(cand, 1, sel) + base


def _pq_encode(index, vectors: np.ndarray) -> np.ndarray:
    """The packed codes of a pq add. The FIRST batch trains the codebooks
    (frozen afterwards, faiss's train-once contract) through the canonical
    encoder (``codes_io.encode_corpus``), so the placed codes equal a
    ``<index>.codes`` file of the same rows byte for byte; later batches
    encode against them."""
    rot = index._rot
    if index._pq is None:
        from clipx_torch.search.codes_io import encode_corpus

        payload = encode_corpus(vectors, "pq", rot=rot)
        index._pq = payload["codebook"]
        if payload["rot_matrix"] is not None:
            # OPQ may have replaced the fixed rotation: queries, later adds
            # and reconstruction use the rotation the codes were made under
            index._rot = payload["rot_matrix"]
        return payload["codes"]
    return index._pq.encode(vectors, rot=rot)


def _pq_append(index, vectors: np.ndarray) -> None:
    """add() of the pq tier (codes from ``_pq_encode``). Placement pads to
    the row bucket; appends write in place and grow as
    ``engine._int8_append`` does."""
    codes = _pq_encode(index, vectors)
    n_new = codes.shape[0]
    if index._codes is None:
        index._place_pq(codes)
        index.ntotal = n_new
        return
    if index.ntotal + _pad_len(n_new) > index._codes.shape[0]:
        index._grow(index.ntotal + _pad_len(n_new))
    index._codes[index.ntotal: index.ntotal + n_new] = torch.from_numpy(
        codes).to(index.device)
    index.ntotal += n_new
