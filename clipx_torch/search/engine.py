"""Maximum-inner-product search on the device (the faiss replacement).

Counterpart of ``clipx/search/engine.py``. The corpus lives on the device
in one of five storage tiers (``--corpus-dtype``):

- ``f32``  — one (N_pad, D) tensor; a search is one matmul plus a two-level
  top-k (exact mode), or an int8 scan whose best segments are rescored
  exactly in f32 (quant mode, which ``--search-mode auto`` picks from 100k
  rows);
- ``bf16`` — the same at half the bytes; scores are f32, as clipx's
  ``preferred_element_type=f32`` gives (rows are upcast exactly in chunks);
- ``int8`` / ``int4`` — per-row symmetric codes ARE the corpus (1 and 0.5
  B/dim), quantized on the host from rotated rows minus the corpus mean;
  the scan is always quantized and the best segments rescore from
  dequantized rows in f32, with the exact ``q·center`` term added back;
- ``pq``   — 4-bit product-quantization codes (``search/pq.py``), scanned
  by the PQ kernel (``ops/pq_scan.py``).

Results are faiss-shaped ``(D, I)``: scores descending, int64 ids, -1 past
``ntotal``. Rows, queries and codes are always returned in user space
(unrotated, centre added back).

Shapes follow clipx so both packages rank the same candidates the same
way: rows pad to the same buckets (padding masked to -inf), appends pad
their length to a power of two >= 128 and grow at the same points, k
rounds up to a power of two, queries pad to the Q bucket. Every top-k is a
stable descending sort, so equal scores (the -inf padding above all) come
out lowest index first, as ``lax.top_k`` orders them.

The host-side quantizers (rotation, centering, int8 and int4 codes) are
numpy copies of clipx's, so codes match clipx's bit for bit.

Arithmetic: queries and float rows meet in full f32. A search on CUDA
turns ``torch.backends.cuda.matmul.allow_tf32`` off while it runs (and
restores it once no search is running), so a caller that enabled TF32 still
gets f32 scores, LUTs and rescores. The int8 and int4 scans are exact
integer arithmetic, as clipx's int32-accumulated ``dot_general`` is: on
CUDA ``torch._int_mm`` (int8 x int8 -> int32); on the CPU an f32 matmul of
the codes, exact because every partial sum is an integer below
127 * 127 * D < 2**24 for D <= 1040.

A flat pq search on CUDA replays one CUDA graph of ``pq._pq_topk`` for
each (Q bucket, k bucket, ntotal, capacity), through ``runtime/graphs.py``,
in place of the eager dispatches of its chunk scans, top-ks, merge and
rescore (~700 at 2^24 rows): the same kernels in the same order, so the
same (D, I) bit for bit. Any change to the codes drops the index's graphs.

IVF (``--search-mode ivf``) is ``search/ivf.py``; the corpus-sharded index
over several devices is ``parallel/mips.py``.
"""

from __future__ import annotations

import functools
import os
import struct
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from clipx_torch.runtime.device import full_f32, resolve_device
from clipx_torch.runtime.graphs import CudaGraphs
from clipx_torch.utils import profiling

_MAGIC = b"CLIPXIDX1\n"
_MIN_BUCKET = 4096
_MAX_Q = 16
_MAX_K = 16384
_CHUNK_W = 8192
_SEG_W = 64

DTYPES = ("f32", "bf16", "int8", "int4", "pq")


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


def _pad_len(n_new: int) -> int:
    """Append length rounded up to a power of two >= 128: clipx pads every
    update so repeated small deltas reuse one compiled shape, and grows when
    the padded update does not fit. The port keeps the rule so capacities,
    and with them every scan's shape, match clipx's."""
    pad = 128
    while pad < n_new:
        pad *= 2
    return pad


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


_BF16_CHUNK = 1 << 18  # rows upcast to f32 at a time (512 MiB at D = 512)


def _float_scores(corpus: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32 scores of f32 queries against f32 or bf16 rows. bf16 rows
    are upcast exactly, a chunk at a time, and multiplied in f32 — the f32
    output of clipx's ``preferred_element_type=f32`` dot (a bf16 product
    would round the scores to bf16)."""
    if corpus.dtype == torch.float32:
        return queries @ corpus.T
    out = torch.empty((queries.shape[0], corpus.shape[0]),
                      dtype=torch.float32, device=corpus.device)
    for i in range(0, corpus.shape[0], _BF16_CHUNK):
        out[:, i: i + _BF16_CHUNK] = queries @ corpus[
            i: i + _BF16_CHUNK].float().T
    return out


def _search_exact(corpus: torch.Tensor, valid: int, queries: torch.Tensor,
                  k: int):
    if corpus.dtype == torch.bfloat16:
        # clipx casts the queries to the storage dtype for this scan
        queries = queries.to(torch.bfloat16).float()
    scores = _float_scores(corpus, queries)
    scores[:, valid:] = float("-inf")
    return _exact_topk(scores, k)


# -- int8 scan + rescore --------------------------------------------------------

def _quantize_device(corpus: torch.Tensor):
    """Symmetric per-row int8 quantization of the scan copy. The f32 upcast
    keeps code rounding exact for a bf16 corpus."""
    c = corpus.float()
    scales = c.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    codes = torch.clamp(torch.round(c / scales), -127, 127).to(torch.int8)
    return codes, scales[:, 0]


# widest code row whose f32 product of int8 codes stays exact: every partial
# sum is an integer of magnitude below 127 * 127 * D < 2**24
_F32_EXACT_DIM = 1040


def _int8_scores(codes: torch.Tensor, q_codes: torch.Tensor) -> torch.Tensor:
    """Exact (N, Q) integer scores codes @ q_codes.T, as f32."""
    if codes.device.type == "cuda":
        q = q_codes.shape[0]
        qp = max(8, -(-q // 8) * 8)  # _int_mm wants a multiple of 8
        rhs = torch.zeros((codes.shape[1], qp), dtype=torch.int8,
                          device=codes.device)
        rhs[:, :q] = q_codes.T
        return torch._int_mm(codes, rhs)[:, :q].float()
    if codes.shape[1] > _F32_EXACT_DIM:
        raise ValueError(f"int8 rows of {codes.shape[1]} codes: the CPU's f32 "
                         f"product is exact only up to {_F32_EXACT_DIM}")
    return codes.float() @ q_codes.float().T


def _query_codes(queries: torch.Tensor) -> torch.Tensor:
    """Per-query int8 codes. The query's positive scale cannot change its
    segment ranking, so it is dropped."""
    q_scale = queries.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(queries / q_scale), -127, 127).to(
        torch.int8)


def _seg_rescore(segmax: torch.Tensor, valid: int, queries: torch.Tensor,
                 k: int, s_cnt: int, rows_of):
    """The top ``s_cnt`` segments by approximate maximum, rescored whole in
    f32 from ``rows_of(seg_idx)`` (Q, s, _SEG_W, D) -> top k."""
    nq = queries.shape[0]
    _, seg_idx = top_k(segmax.T, s_cnt)                          # (Q, s)
    exact = torch.einsum("qd,qswd->qsw", queries, rows_of(seg_idx))
    gids = (seg_idx[:, :, None] * _SEG_W
            + torch.arange(_SEG_W, device=seg_idx.device)[None, None, :])
    exact = exact.masked_fill(gids >= valid, float("-inf"))
    d, sel = top_k(exact.reshape(nq, s_cnt * _SEG_W), k)
    return d, torch.gather(gids.reshape(nq, s_cnt * _SEG_W), 1, sel)


def _int8_segscan(codes: torch.Tensor, scales: torch.Tensor, valid: int,
                  queries: torch.Tensor, k: int, rows_of, base: int = 0):
    """int8 scan -> per-segment max -> top-k segments -> f32 rescore of all
    their rows (clipx's ``_int8_segscan``). ``rows_of`` supplies the rescore
    rows: the exact float rows (quant mode) or the dequantized codes (int8
    storage). ``base`` is the global id of row 0 for sharded callers
    (``parallel/mips.py``), whose ``valid`` is global: a row is valid when
    base + row < valid, and ids come back global."""
    valid = max(valid - base, 0)
    approx = _int8_scores(codes, _query_codes(queries)) * scales[:, None]
    approx[valid:] = float("-inf")
    nq = queries.shape[0]
    segmax = approx.reshape(-1, _SEG_W, nq).amax(dim=1)          # (segs, Q)
    d, ids = _seg_rescore(segmax, valid, queries, k,
                          min(k, segmax.shape[0]), rows_of)
    return d, ids + base


def refuse_int8_element() -> None:
    """clipx's ``CLIPX_INT8_SCAN=element`` picks its older per-element int8
    scan, which ranks differently inside near-duplicate clusters. The port
    has only the segment scan, so it refuses that value instead of ignoring
    it; any other value means the segment scan, as in clipx."""
    if os.environ.get("CLIPX_INT8_SCAN") == "element":
        raise ValueError(
            "CLIPX_INT8_SCAN=element (clipx's per-element int8 scan) is not "
            "ported: clipx_torch has only the segment scan; unset "
            "CLIPX_INT8_SCAN or set it to seg")


def _float_rows_of(corpus: torch.Tensor):
    corpus3 = corpus.reshape(-1, _SEG_W, corpus.shape[1])
    return lambda seg_idx: corpus3[seg_idx].float()


def _dequant_rows_of(codes: torch.Tensor, scales: torch.Tensor, int4=False):
    """rows_of for the coded tiers: the candidate segments' codes times
    their per-row scales, in f32 (the query-side rounding of the scan
    cancels in this rescore)."""
    segs = codes.shape[0] // _SEG_W
    codes3 = codes.reshape(segs, _SEG_W, -1)
    scales2 = scales.reshape(segs, _SEG_W)

    def rows_of(seg_idx):
        c = codes3[seg_idx]
        if int4:
            c = _unpack_int4(c)
        return c.float() * scales2[seg_idx][..., None]

    return rows_of


# -- host-side quantizers (numpy, the same code as clipx's) --------------------

def quantize_rows(vectors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization: returns (int8 codes, scales)."""
    scales = np.abs(vectors).max(axis=1, keepdims=True) / 127.0
    scales = np.maximum(scales, 1e-12).astype(np.float32)
    codes = np.clip(np.rint(vectors / scales), -127, 127).astype(np.int8)
    return codes, scales[:, 0]


# Coded storage quantizes ROTATED rows: one fixed orthogonal matrix, from a
# fixed seed, spreads the energy of anisotropic (CLIP-like) embeddings over
# all dims, which shrinks each row's max|x| and so its quantization step;
# inner products are unchanged. $CLIPX_CORPUS_ROTATE=off disables it.
_ROT_SEED = 0xC11B


@functools.lru_cache(maxsize=8)
def _rotation_matrix(dim: int) -> np.ndarray:
    rng = np.random.default_rng(_ROT_SEED + dim)
    q, r = np.linalg.qr(rng.standard_normal((dim, dim)))
    # sign-fix the QR so the matrix is unique
    q *= np.sign(np.diagonal(r))
    return np.ascontiguousarray(q, dtype=np.float32)


def rotation_enabled() -> bool:
    """Whether coded storage rotates rows ($CLIPX_CORPUS_ROTATE)."""
    return os.environ.get("CLIPX_CORPUS_ROTATE", "on").lower() != "off"


def corpus_rotation(dim: int) -> Optional[np.ndarray]:
    """The (dim, dim) f32 orthogonal rotation for coded storage, or None
    when CLIPX_CORPUS_ROTATE=off."""
    if not rotation_enabled():
        return None
    return _rotation_matrix(dim)


def coded_center_enabled() -> bool:
    """$CLIPX_CODED_CENTER: 'on' (default) quantizes int8/int4 rows as
    residuals from the corpus mean, scored as q·mean + q·residual with the
    mean term exact f32; 'off' quantizes the raw rows."""
    return os.environ.get("CLIPX_CODED_CENTER", "on").lower() != "off"


def corpus_center(vectors: np.ndarray, rot: Optional[np.ndarray],
                  chunk: int = 1 << 18) -> np.ndarray:
    """The canonical rotated-space corpus mean for centered coded storage:
    f64 accumulation over fixed ``chunk`` boundaries from offset 0, so every
    caller derives bit-identical centers (and codes) from the same rows."""
    n, dim = vectors.shape
    acc = np.zeros(dim, np.float64)
    for i in range(0, n, chunk):
        acc += np.asarray(vectors[i: i + chunk], np.float32
                          ).sum(axis=0, dtype=np.float64)
    mean = (acc / max(n, 1)).astype(np.float32)
    if rot is not None:
        mean = np.ascontiguousarray(mean @ rot)
    return mean


def rotate_rows(v: np.ndarray, rot: Optional[np.ndarray],
                chunk: int = 1 << 18) -> np.ndarray:
    """v @ rot, chunked so the matmul transient stays bounded; returns v
    unchanged when rot is None. Unrotate by passing rot.T."""
    if rot is None:
        return v
    out = np.empty((v.shape[0], rot.shape[1]), np.float32)
    for i in range(0, v.shape[0], chunk):
        np.matmul(v[i: i + chunk], rot, out=out[i: i + chunk])
    return out


def quantize_rows_rotated(vectors: np.ndarray, rot: Optional[np.ndarray],
                          int4: bool, chunk: int = 1 << 18,
                          center: Optional[np.ndarray] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate-then-quantize in row chunks (peak extra host RAM is one chunk
    of f32 rows). ``center`` (the rotated-space mean, see corpus_center) is
    subtracted after rotation."""
    quantizer = quantize_rows_int4 if int4 else quantize_rows
    if rot is None and center is None:
        return quantizer(vectors)
    n = vectors.shape[0]
    code_dim = vectors.shape[1] // 2 if int4 else vectors.shape[1]
    codes = np.empty((n, code_dim), np.int8)
    scales = np.empty((n,), np.float32)
    for i in range(0, n, chunk):
        r = (np.matmul(vectors[i: i + chunk], rot) if rot is not None
             else np.asarray(vectors[i: i + chunk], np.float32))
        if center is not None:
            r = r - center
        c, s = quantizer(r)
        codes[i: i + len(c)] = c
        scales[i: i + len(s)] = s
    return codes, scales


# -- int4 storage ---------------------------------------------------------------
#
# Symmetric per-row 4-bit codes packed two per byte in the SPLIT layout
# (byte j = dim j low nibble, dim j + D/2 high nibble, signed), so the scan
# is two int8 products on the nibble views of each row chunk. The scan runs
# ``_INT4_CHUNK`` rows at a time to bound the unpacked transient, and twice
# the int8 tier's segment margin is rescored.

_INT4_CHUNK = 1 << 19
_INT4_SEG_MARGIN = 2
# Per-row scale candidates for the 4-bit quantizer, as fractions of
# max|x|/7: at 16 levels the MSE-optimal uniform quantizer clips outliers.
_INT4_SCALE_ALPHAS = (1.0, 0.9, 0.8, 0.7)


def pack_int4(codes: np.ndarray) -> np.ndarray:
    """(N, D) int8 codes in [-8, 7] -> (N, D/2) packed int8, SPLIT layout:
    byte j holds dim j in the low nibble and dim j + D/2 in the high one."""
    lo = codes[:, : codes.shape[1] // 2].astype(np.uint8) & 0x0F
    hi = (codes[:, codes.shape[1] // 2:].astype(np.uint8) & 0x0F) << 4
    return (lo | hi).view(np.int8)


def unpack_int4_host(packed: np.ndarray) -> np.ndarray:
    """numpy twin of ``_unpack_int4`` (reconstruct()/vectors())."""
    u = packed.view(np.uint8)
    lo = (u & 0x0F).astype(np.int16)
    hi = (u >> 4).astype(np.int16)
    lo = np.where(lo > 7, lo - 16, lo)
    hi = np.where(hi > 7, hi - 16, hi)
    return np.concatenate([lo, hi], axis=-1).astype(np.int8)


def quantize_rows_int4(vectors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row 4-bit quantization, packed two codes per byte. The
    per-row scale is picked by a small MSE search over clipped candidates
    (``_INT4_SCALE_ALPHAS``)."""
    if vectors.shape[1] % 2:
        raise ValueError("int4 storage needs an even dim, "
                         f"got {vectors.shape[1]}")
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    base = np.maximum(np.abs(v).max(axis=1), 1e-12) / 7.0
    best_codes, best_scales, best_err = None, None, None
    for a in _INT4_SCALE_ALPHAS:
        scales = (base * a).astype(np.float32)
        codes = np.clip(np.rint(v / scales[:, None]), -7, 7
                        ).astype(np.int8)
        err = ((codes * scales[:, None] - v) ** 2).sum(axis=1)
        if best_err is None:
            best_codes, best_scales, best_err = codes, scales, err
        else:
            better = err < best_err
            best_codes[better] = codes[better]
            best_scales[better] = scales[better]
            best_err[better] = err[better]
    return pack_int4(best_codes), best_scales


def _nibbles(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D/2) packed int8 -> the two (..., D/2) int8 halves of the SPLIT
    layout, SIGNED nibbles (PQ codes use unsigned ones: ops/pq_scan.py)."""
    p = packed.to(torch.int16)
    lo = (((p & 0x0F) ^ 0x08) - 0x08).to(torch.int8)
    hi = (p >> 4).to(torch.int8)
    return lo, hi


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., D/2) packed int8 -> (..., D) int8 in [-8, 7]."""
    return torch.cat(_nibbles(packed), dim=-1)


def _int4_segscan(packed: torch.Tensor, scales: torch.Tensor, valid: int,
                  queries: torch.Tensor, k: int, base: int = 0):
    """int4 segment scan: per chunk, two int8 products on the nibble views
    -> per-segment maxima; then the top 2k segments rescore from dequantized
    rows (clipx's ``_int4_segscan``). ``base``: as ``_int8_segscan``'s."""
    valid = max(valid - base, 0)
    q_codes = _query_codes(queries)
    n, half = packed.shape
    nq = queries.shape[0]
    chunk = min(n, _INT4_CHUNK)
    if n % chunk:
        raise ValueError(f"int4 capacity {n} not a chunk multiple ({chunk})"
                         " — placement must pad to _bucket_rows")
    segmax = torch.empty((n // _SEG_W, nq), dtype=torch.float32,
                         device=packed.device)
    for start in range(0, n, chunk):
        lo, hi = _nibbles(packed[start: start + chunk])
        raw = (_int8_scores(lo, q_codes[:, :half])
               + _int8_scores(hi, q_codes[:, half:]))
        approx = raw * scales[start: start + chunk, None]
        if valid < start + chunk:
            approx[max(valid - start, 0):] = float("-inf")
        segmax[start // _SEG_W: (start + chunk) // _SEG_W] = approx.reshape(
            -1, _SEG_W, nq).amax(dim=1)
    d, ids = _seg_rescore(segmax, valid, queries, k,
                          min(_INT4_SEG_MARGIN * k, segmax.shape[0]),
                          _dequant_rows_of(packed, scales, int4=True))
    return d, ids + base


def _int8_encode(index, vectors: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The host codes and scales of an int8 or int4 add. The first add of a
    centered index derives the canonical corpus mean from its rows; later
    appends encode against that same center."""
    if (index._codes is None and index._center is None
            and coded_center_enabled()):
        index._center = corpus_center(vectors, index._rot)
    return quantize_rows_rotated(vectors, index._rot, index.int4_storage,
                                 center=index._center)


def _int8_append(index, vectors: np.ndarray) -> None:
    """add() of the int8 and int4 tiers: quantize on the host (the upload is
    1 or 0.5 B/dim), place padded codes and scales on the first add, write
    later appends in place. Padded scale slots hold 1e-12, so a dequantized
    padding row is zero."""
    codes, scales = _int8_encode(index, vectors)
    n_new = vectors.shape[0]
    if index._codes is None:
        index._place_int8(codes, scales)
        index.ntotal = n_new
        return
    if index.ntotal + _pad_len(n_new) > index._codes.shape[0]:
        index._grow(index.ntotal + _pad_len(n_new))
    end = index.ntotal + n_new
    index._codes[index.ntotal: end] = torch.from_numpy(codes).to(index.device)
    index._scales[index.ntotal: end] = torch.from_numpy(scales).to(
        index.device)
    index.ntotal = end


def _to_device_rows(dst: torch.Tensor, src: np.ndarray,
                    step: int = 1 << 20) -> None:
    """Copy host rows (an array or a read-only memmap) into the head of a
    device tensor a chunk at a time, so a memmapped codes file never
    materializes whole in host RAM (and f32 rows bound for a bf16 tensor
    cross as one chunk at a time)."""
    for i in range(0, src.shape[0], step):
        part = np.array(src[i: i + step], dtype=src.dtype)
        dst[i: i + part.shape[0]] = torch.from_numpy(part).to(dst.device)


class VectorIndex:
    """Flat inner-product index over device-resident vectors or codes.
    Row i is external id i (the byte-sorted path rank the indexer assigns).
    ``dtype`` is the storage tier: "f32", "bf16", "int8", "int4" or "pq"."""

    def __init__(self, dim: int, quantized: bool = False, device=None,
                 dtype: str = "f32"):
        from clipx_torch.search import pq as pq_lib

        if dtype not in DTYPES:
            raise ValueError(f"unknown corpus dtype {dtype!r} "
                             f"(one of {', '.join(DTYPES)})")
        self.dim = dim
        self.dtype = dtype
        # coded storage: the codes ARE the corpus, the scan is always
        # quantized and candidates rescore from dequantized rows
        self.pq_storage = dtype == "pq"
        self.int4_storage = dtype == "int4"
        self.int8_storage = dtype == "int8"
        if self.int4_storage and dim % 2:
            raise ValueError(f"int4 storage needs an even dim, got {dim}")
        if self.pq_storage:
            self._code_dim = pq_lib.subspaces(dim) // 2  # packed bytes
        else:
            self._code_dim = dim // 2 if self.int4_storage else dim
        self.quantized = True if self.coded_storage else quantized
        self.device = resolve_device(device)
        self.ntotal = 0
        self.nprobe = 32  # faiss-compatibility no-op (the REPL's 'p')
        self._corpus: Optional[torch.Tensor] = None   # (N_pad, dim) f32/bf16
        self._codes: Optional[torch.Tensor] = None    # scan copy or codes
        self._scales: Optional[torch.Tensor] = None
        self._pq = None  # PQCodebook, trained on the first add
        # coded tiers quantize rotated rows; queries rotate to match and
        # reconstruction unrotates
        self._rot = corpus_rotation(dim) if self.coded_storage else None
        # int8/int4: the rotated-space corpus mean, set on the first add or
        # the codes-file load; scores add q·center back
        self._center: Optional[np.ndarray] = None
        # concurrent first searches quantize the scan copy once
        self._codes_lock = threading.Lock()
        # flat pq on CUDA: one graph a _pq_key; each reads the codes'
        # address, ntotal and the centroids as they were, so any change to
        # the codes clears them
        self._pq_graphs = CudaGraphs(
            self.device, "pq_search",
            lambda key: f"pq search at Q bucket {key[0]}, k bucket {key[1]}")

    @property
    def coded_storage(self) -> bool:
        """True when the quantized codes ARE the corpus (int8/int4/pq)."""
        return self.int8_storage or self.int4_storage or self.pq_storage

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_vectors(cls, vectors, quantized: bool = False, device=None,
                     dtype: str = "f32") -> "VectorIndex":
        idx = cls(dim=vectors.shape[1], quantized=quantized, device=device,
                  dtype=dtype)
        idx.add(vectors)
        return idx

    @classmethod
    def from_codes(cls, payload: dict, device=None) -> "VectorIndex":
        """A coded index straight from a loaded ``<index>.codes`` payload
        (``search/codes_io.py``): nothing is read, quantized or trained. The
        payload's codes are canonical (``codes_io.encode_corpus``), so
        searches equal those of an index rebuilt from f32."""
        from clipx_torch.search.pq import PQCodebook

        tier = payload["tier"]
        idx = cls(dim=payload["dim"], device=device, dtype=tier)
        # the file's subspace width wins over $CLIPX_PQ_DSUB
        idx._code_dim = payload["code_dim"]
        if payload.get("rot_matrix") is not None:
            idx._rot = payload["rot_matrix"]  # trained OPQ rotation
        idx._center = payload.get("center")
        if payload["ntotal"] == 0:
            return idx
        if tier == "pq":
            idx._pq = PQCodebook(payload["centroids"])
            idx._place_pq(payload["codes"])
        else:
            idx._place_int8(payload["codes"], payload["scales"])
        idx.ntotal = payload["ntotal"]
        return idx

    def add(self, vectors) -> None:
        """Append rows (a numpy array; the f32 and bf16 tiers also take a
        tensor on any device); ids continue from the current ntotal. Appends
        write in place; growth re-pads to the next row bucket on the
        device."""
        if self.coded_storage:
            if isinstance(vectors, torch.Tensor):
                vectors = vectors.detach().cpu().numpy()
            vectors = np.ascontiguousarray(vectors, dtype=np.float32)
            if vectors.ndim != 2 or vectors.shape[1] != self.dim:
                raise ValueError(f"expected (n, {self.dim}) vectors, "
                                 f"got {vectors.shape}")
            if vectors.shape[0] == 0:
                return
            if self.pq_storage:
                from clipx_torch.search.pq import _pq_append

                _pq_append(self, vectors)
                self._pq_graphs.clear()  # ntotal moved, codes written
            else:
                _int8_append(self, vectors)
            return
        store = torch.bfloat16 if self.dtype == "bf16" else torch.float32
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
        if self._corpus is None:
            self._corpus = torch.zeros((_bucket_rows(n_new), self.dim),
                                       dtype=store, device=self.device)
        elif self.ntotal + _pad_len(n_new) > self._corpus.shape[0]:
            self._grow(self.ntotal + _pad_len(n_new))
        self._corpus[self.ntotal: self.ntotal + n_new] = rows.to(store)
        self.ntotal += n_new
        self._codes = None  # the int8 scan copy is rebuilt on next search

    def _place_int8(self, codes: np.ndarray, scales: np.ndarray) -> None:
        bucket = _bucket_rows(codes.shape[0])
        self._codes = torch.zeros((bucket, self._code_dim), dtype=torch.int8,
                                  device=self.device)
        self._scales = torch.full((bucket,), 1e-12, dtype=torch.float32,
                                  device=self.device)
        _to_device_rows(self._codes, codes)
        _to_device_rows(self._scales, scales)

    def _place_pq(self, codes: np.ndarray) -> None:
        """Codes live as logical (N_pad, M/2) rows: clipx's lane pairing
        (``pq.pack_factor``) is a TPU layout and has no counterpart."""
        self._pq_graphs.clear()
        self._codes = torch.zeros((_bucket_rows(codes.shape[0]),
                                   self._code_dim), dtype=torch.int8,
                                  device=self.device)
        _to_device_rows(self._codes, codes)

    def _grow(self, need: int) -> None:
        """Re-pad to the bucket of ``need`` rows on the device."""
        new_cap = _bucket_rows(need)
        self._pq_graphs.clear()
        if self.coded_storage:
            codes = torch.zeros((new_cap, self._code_dim), dtype=torch.int8,
                                device=self.device)
            codes[: self._codes.shape[0]] = self._codes
            self._codes = codes
            if self._scales is not None:
                scales = torch.full((new_cap,), 1e-12, dtype=torch.float32,
                                    device=self.device)
                scales[: self._scales.shape[0]] = self._scales
                self._scales = scales
            return
        grown = torch.zeros((new_cap, self.dim), dtype=self._corpus.dtype,
                            device=self.device)
        grown[: self.ntotal] = self._corpus[: self.ntotal]
        self._corpus = grown
        self._codes = None
        self._scales = None

    def _ensure_codes(self) -> None:
        if self._codes is not None:
            return
        with self._codes_lock:
            if self._codes is None:
                codes, self._scales = _quantize_device(self._corpus)
                # set last: a search that sees the codes without the lock
                # also sees their scales
                self._codes = codes

    def shape_key(self, k: int, nprobe=None) -> tuple:
        """The request-dependent shape of a k-row search, for the HTTP
        service's cold-shape gate: a flat scan varies only in the k
        bucket (``nprobe`` is the faiss-compatibility no-op here)."""
        return (_bucket_k(clamp_k(k)),)

    # -- search ---------------------------------------------------------------
    def search(self, queries: np.ndarray,
               k: int) -> Tuple[np.ndarray, np.ndarray]:
        """faiss-shaped search: (D, I), D (Q, k) float32 descending, I
        (Q, k) int64; slots past ntotal get id -1."""
        k = clamp_k(k)
        queries = np.atleast_2d(np.asarray(queries))
        with profiling.span("index.search", queries.shape[0]):
            if self.ntotal == 0:
                return (np.full((queries.shape[0], k), -np.inf, np.float32),
                        np.full((queries.shape[0], k), -1, np.int64))
            queries = np.require(queries, np.float32, ("C", "W"))
            if queries.shape[1] != self.dim:
                raise ValueError(
                    f"query dim {queries.shape[1]} != index dim {self.dim} "
                    "(is --model the one this index was built with?)")
            if queries.shape[0] > _MAX_Q:
                parts = [self.search(queries[i: i + _MAX_Q], k)
                         for i in range(0, queries.shape[0], _MAX_Q)]
                return (np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]))
            queries = rotate_rows(queries, self._rot)  # match rotated codes
            queries, nq = _pad_q(queries)
            cap_rows = (self._codes if self.coded_storage
                        else self._corpus).shape[0]
            kk = min(_bucket_k(k), cap_rows)
            with torch.inference_mode(), full_f32(self.device):
                if self.pq_storage and self.device.type == "cuda":
                    # (D, I) leave the graph's static output under its lock
                    scores, ids = self._pq_graphs.run(
                        self._pq_key(queries.shape[0], kk),
                        torch.from_numpy(queries).pin_memory(),
                        lambda qt: self._pq_search(qt, kk),
                        lambda out: (out[0][:nq, :k].cpu().numpy(),
                                     out[1][:nq, :k].cpu().numpy()))
                else:
                    scores, ids = self._scan(
                        torch.from_numpy(queries).to(self.device), kk)
                    scores = scores[:nq, :k].cpu().numpy()
                    ids = ids[:nq, :k].to(torch.int64).cpu().numpy()
            if self._center is not None:
                # centered codes score the residual: add the exact q·mean
                # back (a per-query constant, so the ranking is already
                # right)
                scores = scores + (queries[:nq] @ self._center)[:, None]
            ids[~np.isfinite(scores)] = -1
            if scores.shape[1] < k:  # tiny corpus, huge (clamped) k
                pad = k - scores.shape[1]
                scores = np.pad(scores, ((0, 0), (0, pad)),
                                constant_values=-np.inf)
                ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
            return scores, ids

    def _scan(self, qt: torch.Tensor, kk: int):
        """The device search of the padded, rotated queries ``qt``: (Q, kk)
        scores and ids, in this index's tier."""
        if self.pq_storage:
            return self._pq_search(qt, kk)
        if self.int4_storage:
            return _int4_segscan(self._codes, self._scales, self.ntotal, qt,
                                 kk)
        if self.int8_storage:
            return _int8_segscan(self._codes, self._scales, self.ntotal, qt,
                                 kk, _dequant_rows_of(self._codes,
                                                      self._scales))
        if self.quantized:
            refuse_int8_element()
            self._ensure_codes()
            return _int8_segscan(self._codes, self._scales, self.ntotal, qt,
                                 kk, _float_rows_of(self._corpus))
        return _search_exact(self._corpus, self.ntotal, qt, kk)

    def _pq_search(self, qt: torch.Tensor, kk: int):
        from clipx_torch.search.pq import _pq_topk

        return _pq_topk(self._codes, self._pq.device(self.device),
                        self.ntotal, qt, kk)

    def _pq_key(self, q_bucket: int, kk: int) -> tuple:
        """What a captured pq search holds fixed besides the codes' address
        and the centroids: the Q bucket, the k bucket, ntotal (the valid
        masks) and the capacity (the chunking)."""
        return (q_bucket, kk, self.ntotal, self._codes.shape[0])

    # -- reconstruction ---------------------------------------------------------
    def _user_space(self, v: np.ndarray) -> np.ndarray:
        """Rotated-space rows (centre added back) -> user space."""
        if self._center is not None:
            v = v + self._center
        return rotate_rows(v, None if self._rot is None else self._rot.T)

    def reconstruct(self, row: int) -> np.ndarray:
        if not (0 <= row < self.ntotal):
            raise IndexError(row)
        return self._rows(row, row + 1)[0]

    def vectors(self) -> np.ndarray:
        """All rows, (ntotal, dim) f32, in user space (decoded and unrotated
        for the coded tiers)."""
        if self.ntotal == 0:
            return np.zeros((0, self.dim), dtype=np.float32)
        return self._rows(0, self.ntotal)

    def _rows(self, start: int, end: int) -> np.ndarray:
        if not self.coded_storage:
            return self._corpus[start:end].float().cpu().numpy()
        c = self._codes[start:end].cpu().numpy()
        if self.pq_storage:
            return self._user_space(self._pq.decode(c))
        if self.int4_storage:
            c = unpack_int4_host(c)
        scales = self._scales[start:end].cpu().numpy()
        return self._user_space(c.astype(np.float32) * scales[:, None])


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


def read_index_vectors(path: str, mmap: bool = False) -> np.ndarray:
    """Parse the sidecar into a host (ntotal, dim) float32 array; with
    ``mmap=True`` a read-only memmap view (the coded-tier encoders stream
    it in chunks, so a huge sidecar never materializes in host RAM)."""
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
        if mmap:
            if os.path.getsize(path) < len(_MAGIC) + 16 + ntotal * dim * 4:
                raise ValueError(f"{path!r} is truncated")
            if ntotal == 0:
                return np.zeros((0, dim), np.float32)
            return np.memmap(path, np.float32, "r",
                             offset=len(_MAGIC) + 16, shape=(ntotal, dim))
        raw = f.read(ntotal * dim * 4)
        if len(raw) != ntotal * dim * 4:
            raise ValueError(f"{path!r} is truncated "
                             f"({len(raw)} of {ntotal * dim * 4} bytes)")
    return np.frombuffer(raw, dtype=np.float32).reshape(ntotal, dim)


def content_hash(vectors: np.ndarray) -> bytes:
    """blake2b-16 of the raw f32 row bytes (clipx's ``engine.content_hash``;
    ``IndexWriter.content_hash`` of the same rows): the key of the ``.ivf``
    cache and of a codes file's corpus."""
    import hashlib

    v = np.ascontiguousarray(vectors, dtype=np.float32)
    h = hashlib.blake2b(digest_size=16)
    h.update(memoryview(v).cast("B"))
    return h.digest()


def read_index(path: str, device=None, dtype: str = "f32") -> VectorIndex:
    data = read_index_vectors(path)
    index = VectorIndex(dim=data.shape[1], device=device, dtype=dtype)
    if data.shape[0]:
        index.add(data)
    return index
