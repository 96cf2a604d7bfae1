"""IVF search (``--search-mode ivf``): the functional ``nprobe`` knob.

Counterpart of ``clipx/search/ivf.py``'s single-device ``IVFIndex``. The
reference builds a faiss ``IndexIVFFlat`` (k-means into cells; a query
scans the ``nprobe`` closest cells). Here, as in clipx:

- **Cluster-pure segments.** Spherical k-means assigns every row to a
  cluster; rows are reordered so each cluster's members are contiguous and
  each cluster pads to a 64-row boundary (``cluster_layout``). The corpus is
  viewed as (S, 64, D) segments, with a row -> external-id map (-1 on the
  dead padding rows).
- **Segment centroids as the coarse quantizer.** A query probes the top
  ``P`` segments by centroid score, ``P`` = ``nprobe``% of the segments
  rounded up to a probe bucket (``_bucket_probe``), and ranks their rows.
- **Tiers.** f32 / bf16 score the probed rows exactly; ``quantized`` scans
  them in int8 and rescores the best segments in f32. int8 / int4 codes ARE
  the corpus (rescored from dequantized rows); pq scans the probed segments'
  4-bit codes with the PQ kernel (``ops/pq_scan.py``, B11) one (query,
  32k-row chunk) at a time, keeps a 4k candidate margin and rescores it
  against the f32 LUT. (clipx chunks by a divisor rule fit to its TPU
  tile; the candidates do not depend on the chunking.) Residual pq
  (``$CLIPX_PQ_RESIDUAL``, default on) encodes each row against its
  segment centroid and adds the exact coarse score back.
- **Exact tail for adds.** Appended rows go to a flat exact index merged
  into every search.

The ``.ivf`` cache (layout + per-segment sums, keyed by the content hash of
the f32 rows) has clipx's format, so a cache written by either package
loads in the other. The port's k-means draws its sample and initial
centroids from ``numpy.random.default_rng(seed)`` (clipx uses
``jax.random``), so a layout the port trains differs from clipx's; given
one layout (a shared ``.ivf``) both return the same ids. Per-cluster sums
are one-hot f32 products, never float atomics, so two builds on one card
give one layout (and one ``layout_digest`` for residual codes).

Arithmetic keeps clipx's rounding points: int8 scans are exact integer
sums (``engine._int8_scores``), the PQ scan's are exact integer LUT sums,
every top-k breaks ties lowest index first. Queries are not padded to the Q
bucket: each query's probe is independent of the others.

``ShardedIVFIndex`` deals the segments round-robin over a ``"shard"``
mesh (``parallel/mesh.py``): each shard probes its local top segments and
the candidates merge as in ``parallel/mips.py``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from clipx_torch.ops.pq_scan import pq_scan_scores, unpack_codes4
from clipx_torch.runtime.device import full_f32, resolve_device
from clipx_torch.search import engine
from clipx_torch.search import pq as pq_lib
from clipx_torch.search.engine import _SEG_W, clamp_k, top_k

# assignment row chunk: bounds the (chunk, C) score buffer
_ASSIGN_CHUNK = 65536
# rows per one-hot product of the k-means cluster sums: a (chunk, C) f32
# one-hot is 256 MiB at C = 4096
_SUM_CHUNK = 16384
# max rows sampled for k-means training
_TRAIN_CAP = 131072
# per-call byte budget for the probed-segment gathers; queries are chunked
# so the gather transients stay under it
_GATHER_BUDGET = 1 << 30
# probed rows the PQ probe scans a B11 launch (a query's last chunk may be
# smaller): clipx's ~32k-row chunk target
_PROBE_CHUNK_ROWS = 32768


def _qcap(P: int, dim: int, quantized: bool, k: int,
          int8_storage: bool = False, pq_mk: int = 0) -> int:
    """Max query rows per probe call, a power of two, bounded by the
    gather-byte budget: one (Q, P, W, D) f32 gather; or int8 probe rows plus
    a (Q, s, W, D) f32 rescore gather (clipx's rule for these tiers); or,
    for pq (``pq_mk`` = M*16), one probe chunk's rows times the LUT width
    plus the rescore's gathered LUT. Query chunking does not change the
    results."""
    if pq_mk:
        m_cand = min(pq_lib.PQ_RESCORE_MARGIN * engine._bucket_k(k),
                     P * _SEG_W)
        rows = _pq_chunk_segs(P, _SEG_W) * _SEG_W
        per_q = pq_mk * (rows + 4 * m_cand)
    elif int8_storage:
        s = min(engine._bucket_k(k), P * _SEG_W, P)
        per_q = _SEG_W * dim * (P + 5 * s)
    elif quantized:
        s = min(engine._bucket_k(k), P * _SEG_W, P)
        per_q = _SEG_W * dim * (P + 4 * s)
    else:
        per_q = P * _SEG_W * dim * 4
    qcap = max(1, _GATHER_BUDGET // max(1, per_q))
    qcap = min(qcap, engine._MAX_Q)
    return 1 << (qcap.bit_length() - 1)


def _num_clusters(n: int) -> int:
    """~256 rows (4 segments) per cluster, clamped to a sane range."""
    return int(np.clip(n // 256, 16, 4096))


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

def _normalize(c: torch.Tensor) -> torch.Tensor:
    return c / torch.linalg.vector_norm(c, dim=1, keepdim=True).clamp_min(
        1e-12)


def _assign_chunk(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by inner product, first index on ties."""
    return torch.argmax(x @ cent.T, dim=1)


def _assign(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    return torch.cat([_assign_chunk(x[i: i + _ASSIGN_CHUNK], cent)
                      for i in range(0, x.shape[0], _ASSIGN_CHUNK)])


def _cluster_sums(x: torch.Tensor, a: torch.Tensor, C: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster row sums and counts. The sums are one-hot f32 products in
    fixed chunks, so they come out the same on every run (``index_add_``
    would add with float atomics on CUDA, in an order that changes)."""
    ids = torch.arange(C, device=x.device)
    sums = torch.zeros((C, x.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], _SUM_CHUNK):
        onehot = (a[i: i + _SUM_CHUNK, None] == ids).to(torch.float32)
        sums += onehot.T @ x[i: i + _SUM_CHUNK]
    counts = torch.bincount(a, minlength=C).to(torch.float32)
    return sums, counts


def _kmeans(x: torch.Tensor, C: int, iters: int,
            rng: np.random.Generator) -> torch.Tensor:
    """Spherical k-means (unit-norm centroids: CLIP embeddings are
    normalized, so cosine cells are the right geometry). Returns (C, D) f32
    centroids; empty cells keep their previous centroid."""
    init = rng.choice(x.shape[0], C, replace=False)
    cent = _normalize(x[torch.from_numpy(init).to(x.device)])
    for _ in range(iters):
        sums, counts = _cluster_sums(x, _assign(x, cent), C)
        new = sums / counts.clamp_min(1.0)[:, None]
        cent = _normalize(torch.where(counts[:, None] > 0, new, cent))
    return cent


def train_clusters(vectors: np.ndarray, *, iters: int = 8, seed: int = 0,
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """K-means the corpus on ``device`` in full f32. Returns (assign,
    centroids): per-row cluster ids and the (C, D) unit-norm centers.

    Training samples at most ``_TRAIN_CAP`` rows (a host fancy-index:
    ``vectors`` may be a sidecar memmap) and assignment streams
    ``_ASSIGN_CHUNK``-row slices to the device, so the corpus never lies on
    the device whole. The sample and the initial centroids come from
    ``numpy.random.default_rng(seed)``."""
    device = resolve_device(device)
    n = vectors.shape[0]
    C = min(_num_clusters(n), n)
    rng = np.random.default_rng(seed)
    if n > _TRAIN_CAP:
        sample = np.sort(rng.choice(n, _TRAIN_CAP, replace=False))
        train = vectors[sample]
    else:
        train = vectors

    def rows(x):  # a writable host copy (vectors may be a read-only memmap)
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    with torch.inference_mode(), full_f32(device):
        cent = _kmeans(rows(train), C, iters, rng)
        parts = [_assign_chunk(rows(vectors[i: i + _ASSIGN_CHUNK]),
                               cent).to(torch.int32).cpu().numpy()
                 for i in range(0, n, _ASSIGN_CHUNK)]
        cent = cent.cpu().numpy()
    assign = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
    return assign, cent


def cluster_layout(assign: np.ndarray) -> np.ndarray:
    """Pack cluster members into 64-row segments that never straddle a
    cluster boundary: each cluster's rows (by external id) padded to a
    multiple of _SEG_W with -1 slots. Returns ``row_ext``, the internal-row
    -> external-id map, -1 marking dead padding rows."""
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    pieces = []
    start = 0
    for end in np.append(
            np.flatnonzero(np.diff(sorted_assign)) + 1, len(order)):
        members = order[start:end]
        pad = (-len(members)) % _SEG_W
        pieces.append(members)
        if pad:
            pieces.append(np.full(pad, -1, dtype=np.int64))
        start = end
    if not pieces:
        return np.zeros((0,), np.int64)
    return np.concatenate(pieces).astype(np.int64)


# ---------------------------------------------------------------------------
# probe bodies
# ---------------------------------------------------------------------------

def _coarse(queries: torch.Tensor, seg_cent: torch.Tensor, P: int,
            seg_valid: Optional[torch.Tensor] = None):
    """(Q, P) scores and ids of each query's top-P segments by centroid;
    segments where ``seg_valid`` is False (a shard's all-dead alignment
    segments) score -inf."""
    scores = queries @ seg_cent.T
    if seg_valid is not None:
        scores = scores.masked_fill(~seg_valid, float("-inf"))
    return top_k(scores, P)


def _gids(seg_idx: torch.Tensor) -> torch.Tensor:
    """(Q, s) segment ids -> (Q, s, W) internal row ids."""
    return (seg_idx[:, :, None] * _SEG_W
            + torch.arange(_SEG_W, device=seg_idx.device)[None, None, :])


def _ivf_kernel_f32(corpus3: torch.Tensor, seg_cent: torch.Tensor,
                    valid2: torch.Tensor, queries: torch.Tensor,
                    P: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """corpus3: (S, 64, D) f32 or bf16 cluster-packed rows; valid2: (S, 64)
    live rows. Probes the top-P segments and scores their rows in exact f32
    (IVFFlat semantics; bf16 rows upcast, the queries stay f32, as clipx's
    mixed-type einsum promotes). Returns (Q, k) scores and INTERNAL row ids
    (dead rows -> -inf)."""
    _, seg_idx = _coarse(queries, seg_cent, P)
    return _f32_probe_body(corpus3, valid2, queries, seg_idx, k)


def _f32_probe_body(corpus3: torch.Tensor, valid2: torch.Tensor,
                    queries: torch.Tensor, seg_idx: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 scores of every row of the (Q, P) probed segments, top k
    (internal ids)."""
    nq, P = seg_idx.shape
    exact = torch.einsum("qd,qpwd->qpw", queries, corpus3[seg_idx].float())
    exact = exact.masked_fill(~valid2[seg_idx], float("-inf"))
    kk = min(k, P * _SEG_W)
    d, sel = top_k(exact.reshape(nq, P * _SEG_W), kk)
    return d, torch.gather(_gids(seg_idx).reshape(nq, P * _SEG_W), 1, sel)


def _scan_raw_int8(codes3: torch.Tensor):
    """The int8 probe scan: (Q, P, W) exact integer scores (as f32) of each
    query's codes against its probed segments, one integer product per
    query (``engine._int8_scores``: ``torch._int_mm`` on CUDA)."""
    def scan(seg_idx, q_codes):
        nq, p = seg_idx.shape
        return torch.stack([
            engine._int8_scores(codes3[seg_idx[q]].reshape(
                p * _SEG_W, -1), q_codes[q: q + 1])[:, 0]
            for q in range(nq)]).reshape(nq, p, _SEG_W)
    return scan


def _scan_raw_int4(packed3: torch.Tensor):
    """The int4 probe scan: gather the PACKED segments and score the two
    nibble views (SPLIT layout) with two integer products."""
    def scan(seg_idx, q_codes):
        nq, p = seg_idx.shape
        half = packed3.shape[-1]
        out = []
        for q in range(nq):
            lo, hi = engine._nibbles(
                packed3[seg_idx[q]].reshape(p * _SEG_W, half))
            out.append((engine._int8_scores(lo, q_codes[q: q + 1, :half])
                        + engine._int8_scores(hi, q_codes[q: q + 1, half:])
                        )[:, 0])
        return torch.stack(out).reshape(nq, p, _SEG_W)
    return scan


def _int8_probe_body(codes3: torch.Tensor, scales2: torch.Tensor,
                     valid2: torch.Tensor, queries: torch.Tensor,
                     seg_idx: torch.Tensor, rescore_rows, s: int, k: int,
                     scan_raw=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared body of the int8 probes: quantize the queries, int8-scan the
    probed segments (``scan_raw``, default the int8 scan), keep the top-``s``
    segments by per-segment max, rescore their rows in exact f32 (rows from
    ``rescore_rows(chosen)``), final top-k."""
    nq = queries.shape[0]
    scan = scan_raw or _scan_raw_int8(codes3)
    approx = scan(seg_idx, engine._query_codes(queries)) * scales2[seg_idx]
    approx = approx.masked_fill(~valid2[seg_idx], float("-inf"))
    _, local = top_k(approx.amax(dim=2), s)                     # (Q, s)
    chosen = torch.gather(seg_idx, 1, local)
    exact = torch.einsum("qd,qswd->qsw", queries, rescore_rows(chosen))
    exact = exact.masked_fill(~valid2[chosen], float("-inf"))
    kk = min(k, s * _SEG_W)
    d, sel = top_k(exact.reshape(nq, s * _SEG_W), kk)
    return d, torch.gather(_gids(chosen).reshape(nq, s * _SEG_W), 1, sel)


def _dequant_rows(codes3: torch.Tensor, scales2: torch.Tensor):
    """rescore_rows for int8 storage: the chosen rows dequantized in f32
    (the scan's query-side rounding cancels; corpus rounding remains)."""
    return lambda chosen: (codes3[chosen].float()
                           * scales2[chosen][..., None])


def _dequant_rows_int4(packed3: torch.Tensor, scales2: torch.Tensor):
    """rescore_rows for int4 storage: unpack, then dequantize."""
    return lambda chosen: (engine._unpack_int4(packed3[chosen]).float()
                           * scales2[chosen][..., None])


def _ivf_kernel_int8(codes3, scales2, corpus3, seg_cent, valid2, queries,
                     P: int, k: int):
    """Quantized f32/bf16 tier: int8 probed scan of the scan copy + exact
    f32 rescore of the stored rows of the top-k segments."""
    _, seg_idx = _coarse(queries, seg_cent, P)
    return _int8_probe_body(codes3, scales2, valid2, queries, seg_idx,
                            lambda chosen: corpus3[chosen].float(),
                            min(k, P), k)


def _ivf_kernel_int8_pure(codes3, scales2, seg_cent, valid2, queries,
                          P: int, k: int):
    """int8 storage: the codes are the corpus; rescore from dequantized
    candidates."""
    _, seg_idx = _coarse(queries, seg_cent, P)
    return _int8_probe_body(codes3, scales2, valid2, queries, seg_idx,
                            _dequant_rows(codes3, scales2), min(k, P), k)


def _ivf_kernel_int4_pure(packed3, scales2, seg_cent, valid2, queries,
                          P: int, k: int):
    """int4 storage: packed (S, 64, D/2) codes; the scan scores the nibble
    views, the rescore dequantizes the unpacked candidates."""
    _, seg_idx = _coarse(queries, seg_cent, P)
    return _int8_probe_body(packed3, scales2, valid2, queries, seg_idx,
                            _dequant_rows_int4(packed3, scales2),
                            min(k, P), k, scan_raw=_scan_raw_int4(packed3))


def _pq_chunk_segs(P: int, W: int) -> int:
    """Probed segments a chunk of the PQ probe: _PROBE_CHUNK_ROWS rows,
    the last chunk ragged. (clipx's rule must divide P evenly and, at
    nprobe 100, degenerates down to one segment a chunk.) The chunking does
    not change the results: see _pq_probe_body."""
    return max(1, min(P, _PROBE_CHUNK_ROWS // W))


def _pq_probe_body(codes3: torch.Tensor, centroids: torch.Tensor,
                   valid2: torch.Tensor, queries: torch.Tensor,
                   seg_idx: torch.Tensor, k: int,
                   seg_scores: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PQ probed scan (faiss IVFPQ): codes3 (S, 64, M/2) logical rows. The
    probed segments are scanned ``_pq_chunk_segs`` at a time; each (query,
    chunk) is one ``pq_scan_scores`` call at Q = 1 with that query's int8
    LUT column (on CUDA, one launch of B11's kernel). Each chunk keeps its
    top ``min(m_cand, chunk rows)`` by approximate score, the chunks merge
    to the m_cand = 4k margin, and the margin rescores against the f32
    LUT: returned scores are exact PQ scores.

    The candidates are those of one top-m_cand over every probed row, for
    any chunking (so clipx's, whose chunks differ): a chunk keeps all of
    its rows among the global top m_cand, the chunks concatenate in
    probed-row order, and every top-k breaks ties lowest index first.

    RESIDUAL mode (``seg_scores``, the (Q, P) exact coarse scores): codes
    encode residuals against their segment centroid, so the scan applies
    the per-query LUT scale and adds the segment's coarse score, and the
    rescore adds it back exactly: score = q.cent + q.decode(residual)."""
    nq = queries.shape[0]
    half = centroids.shape[0] // 2
    P, W = seg_idx.shape[1], codes3.shape[1]
    lut, luti, lut_scale = pq_lib.quantized_luts(queries, centroids)
    rows = P * W
    kk = min(k, rows)
    m_cand = min(pq_lib.PQ_RESCORE_MARGIN * kk, rows)
    pc = _pq_chunk_segs(P, W)
    lut_cols = [luti[q][:, None] for q in range(nq)]          # (M*16, 1)

    def scan_chunk(s0):
        cs = seg_idx[:, s0: s0 + pc]                          # (Q, <= pc)
        rows_c = cs.shape[1] * W
        approx = torch.cat([
            pq_scan_scores(codes3[cs[q]].reshape(rows_c, half), lut_cols[q])
            for q in range(nq)])                              # (Q, rows_c)
        if seg_scores is not None:
            cv = seg_scores[:, s0: s0 + pc]
            approx = approx * lut_scale + cv.repeat_interleave(W, dim=1)
        vm = valid2[cs].reshape(nq, rows_c)
        d, li = top_k(approx.masked_fill(~vm, float("-inf")),
                      min(m_cand, rows_c))
        return d, li + s0 * W

    parts = [scan_chunk(s0) for s0 in range(0, P, pc)]
    # per query, chunk-major: probed-row order
    d_all = torch.cat([d for d, _ in parts], dim=1)
    i_all = torch.cat([i for _, i in parts], dim=1)
    _, pos = top_k(d_all, m_cand)
    cand = torch.gather(i_all, 1, pos)                        # (Q, m_cand)

    # f32-LUT rescore of the candidates (flat probed index -> segment, row)
    cseg, crow = cand // W, cand % W
    gseg = torch.gather(seg_idx, 1, cseg)                     # (Q, m)
    codes = unpack_codes4(codes3[gseg, crow]).long()          # (Q, m, M)
    lut3 = lut.reshape(nq, 1, 2 * half, pq_lib.PQ_K).expand(
        nq, m_cand, -1, -1)
    exact = torch.gather(lut3, 3, codes[..., None])[..., 0].sum(dim=-1)
    if seg_scores is not None:
        exact = exact + torch.gather(seg_scores, 1, cseg)
    exact = exact.masked_fill(~valid2[gseg, crow], float("-inf"))
    d, s2 = top_k(exact, kk)
    return d, torch.gather(gseg * W + crow, 1, s2)


def _ivf_kernel_pq(codes3, centroids, seg_cent, valid2, queries, P: int,
                   k: int, residual: bool = False):
    """pq storage: probed product-quantized search; with ``residual`` the
    probe's own coarse scores complete the residual codes."""
    cvals, seg_idx = _coarse(queries, seg_cent, P)
    return _pq_probe_body(codes3, centroids, valid2, queries, seg_idx, k,
                          seg_scores=cvals if residual else None)


def _segment_stats(corpus3: torch.Tensor, counts: torch.Tensor
                   ) -> torch.Tensor:
    """Per-segment mean over valid rows (padding rows are zero and
    excluded by the per-segment count)."""
    return corpus3.float().sum(dim=1) / counts.clamp_min(1.0)[:, None]


def _bucket_probe(p: int) -> int:
    """Probe-count bucket >= p, in steps of 2^n and 1.5*2^n (overshoot at
    most ~33%)."""
    b = 1
    while True:
        if b >= p:
            return b
        if b + b // 2 >= p:
            return b + b // 2
        b *= 2


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------

class IVFIndex:
    """Approximate inner-product index with a functional ``nprobe``:
    ``nprobe``/100 of the segments are probed (the reference's nlist is 100,
    so ``p N`` means "scan ~N% of the corpus"); ``nprobe=100`` probes all of
    them and returns the flat exact ranking. faiss-shaped search: (D, I)
    with external ids, -1 past ntotal."""

    supports_nprobe = True

    def __init__(self, dim: int, quantized: bool = False, dtype: str = "f32",
                 device=None):
        if dtype not in engine.DTYPES:
            raise ValueError("IVF corpus dtype must be f32, bf16, int8, "
                             f"int4 or pq, got {dtype!r}")
        self.dim = dim
        self.dtype = dtype
        self.device = resolve_device(device)
        self.pq_storage = dtype == "pq"
        self.int4_storage = dtype == "int4"
        self.int8_storage = dtype == "int8"
        if self.int4_storage and dim % 2:
            raise ValueError(f"int4 storage needs an even dim, got {dim}")
        if self.pq_storage:
            pq_lib.subspaces(dim)  # validates divisibility
        # codes-as-corpus has no unquantized scan to fall back to
        self.quantized = True if self.coded_storage else quantized
        self.ntotal = 0
        self._nprobe = 32  # reference:query-index.py:30
        self._corpus3: Optional[torch.Tensor] = None   # (S, 64, D) f32/bf16
        self._seg_cent: Optional[torch.Tensor] = None  # (S, D) f32
        self._valid2: Optional[torch.Tensor] = None    # (S, 64) bool
        self._row_ext: Optional[np.ndarray] = None     # (S*64,) ext id, -1
        self._codes3: Optional[torch.Tensor] = None
        self._scales2: Optional[torch.Tensor] = None
        self._pq = None  # PQCodebook (pq storage)
        # pq codes encode residuals against segment centroids (set at
        # install from $CLIPX_PQ_RESIDUAL or the codes-file payload)
        self._residual = False
        self._base_n = 0
        self._tail: Optional[engine.VectorIndex] = None
        # ascending cumulative sums of live-segment occupancies
        # (_probe_floor)
        self._live_count_cumsum: Optional[np.ndarray] = None
        # coded storage quantizes rotated rows and probes rotated
        # centroids; queries rotate to match, reconstruction unrotates
        self._rot = (engine.corpus_rotation(dim) if self.coded_storage
                     else None)
        # centered int8/int4: codes are residuals from the corpus mean;
        # search adds the exact q·mean back
        self._center: Optional[np.ndarray] = None
        # the flat-order encode payload of the last install, kept only
        # when the caller asked for it (stash_codes) to write the codes file
        self._pending_codes_payload: Optional[dict] = None
        # concurrent first searches quantize the probe copy once
        self._codes_lock = threading.Lock()

    @property
    def coded_storage(self) -> bool:
        """True when the quantized codes ARE the corpus (int8/int4/pq)."""
        return self.int8_storage or self.int4_storage or self.pq_storage

    @property
    def nprobe(self) -> int:
        return self._nprobe

    @nprobe.setter
    def nprobe(self, v: int) -> None:
        # clamped as the reference REPL clamps it (1..100)
        self._nprobe = int(np.clip(int(v), 1, 100))

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_vectors(cls, vectors: np.ndarray, *, quantized: bool = False,
                     cache_path: Optional[str] = None, seed: int = 0,
                     dtype: str = "f32", device=None,
                     stash_codes: bool = False, **index_kw) -> "IVFIndex":
        """Train (or load from ``cache_path``) the layout and install
        ``vectors``. ``stash_codes`` keeps a coded tier's flat-order encode
        on ``_pending_codes_payload`` so the caller can write the codes file
        without encoding again. ``index_kw`` goes to the constructor (a
        sharded index's ``mesh``)."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        idx = cls(dim=vectors.shape[1], quantized=quantized, dtype=dtype,
                  device=device, **index_kw)
        if vectors.shape[0] == 0:
            return idx
        layout = None
        if cache_path and os.path.exists(cache_path):
            layout = _load_cache(cache_path, vectors)
        if layout is None:
            assign, _ = train_clusters(vectors, seed=seed, device=idx.device)
            layout = cluster_layout(assign)
            if cache_path:
                _save_cache(cache_path, vectors, layout)
        idx._install(vectors, layout, stash_codes=stash_codes)
        pending = idx._pending_codes_payload
        if pending is not None and pending.get("residual"):
            # bind the residual codes to the layout they were encoded under
            pending["layout_digest"] = layout_digest(layout)
        return idx

    @classmethod
    def from_codes(cls, payload: dict, cache_path: str, *,
                   quantized: bool = False, device=None,
                   **index_kw) -> Optional["IVFIndex"]:
        """A coded-storage IVF index from a loaded ``<index>.codes`` payload
        plus the v2 ``.ivf`` cache (layout + per-segment sums): no f32 rows
        read, no k-means, no re-encode. None when the cache is absent,
        pre-v2, or keyed to another corpus (or, for residual codes, another
        layout) than the codes file."""
        dtype = payload["tier"]
        if payload["ntotal"] == 0:
            return cls(dim=payload["dim"], quantized=quantized, dtype=dtype,
                       device=device, **index_kw)
        cache = _load_cache_for_codes(cache_path, payload)
        if cache is None:
            return None
        layout, sums = cache
        idx = cls(dim=payload["dim"], quantized=quantized, dtype=dtype,
                  device=device, **index_kw)
        idx._install(None, layout, coded=payload, seg_sums=sums)
        return idx

    def _probe_floor(self, k: int) -> int:
        """Smallest probe count that guarantees k valid rows whatever is
        probed: the s emptiest live segments together hold >= k rows."""
        cs = self._live_count_cumsum
        if cs is None or not len(cs):
            return 1
        return int(min(np.searchsorted(cs, k) + 1, len(cs)))

    def _install(self, vectors: Optional[np.ndarray], row_ext: np.ndarray, *,
                 coded: Optional[dict] = None,
                 seg_sums: Optional[np.ndarray] = None,
                 stash_codes: bool = False) -> None:
        """row_ext: internal-row -> external-id map (-1 = dead padding row),
        a multiple of _SEG_W long (see cluster_layout).

        Coded tiers install by PERMUTING canonical flat-order codes (the
        bytes a ``<index>.codes`` file stores) into the layout, never by
        encoding permuted rows. ``coded`` supplies a loaded payload (where
        ``vectors`` is None and ``seg_sums`` carries the cached per-segment
        sums); otherwise the canonical encoder runs here. Dead padding rows
        get zero codes and 1e-12 scales; every scan masks them."""
        n = coded["ntotal"] if vectors is None else vectors.shape[0]
        dev = self.device
        segs = len(row_ext) // _SEG_W
        live = row_ext >= 0
        valid2 = live.reshape(segs, _SEG_W)
        counts = valid2.sum(axis=1).astype(np.float32)
        if self.coded_storage:
            codes, scales, cent = self._coded_layout(
                vectors, row_ext, live, counts, coded, seg_sums, stash_codes)
            self._corpus3 = None
            self._codes3 = torch.from_numpy(codes.reshape(
                segs, _SEG_W, codes.shape[1])).to(dev)
            self._scales2 = (None if scales is None else torch.from_numpy(
                scales.reshape(segs, _SEG_W)).to(dev))
            self._seg_cent = torch.from_numpy(cent).to(dev)
        else:
            padded = np.zeros((segs * _SEG_W, self.dim), np.float32)
            padded[live] = vectors[row_ext[live]]
            self._corpus3 = torch.from_numpy(padded.reshape(
                segs, _SEG_W, self.dim)).to(dev).to(self._store_dtype())
            del padded
            self._seg_cent = _segment_stats(
                self._corpus3, torch.from_numpy(counts).to(dev))
            self._codes3 = None
            self._scales2 = None
        self._valid2 = torch.from_numpy(valid2).to(dev)
        self._index_rows(row_ext, n)

    def _store_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bf16" else torch.float32

    def _coded_layout(self, vectors, row_ext: np.ndarray, live: np.ndarray,
                      counts: np.ndarray, coded: Optional[dict],
                      seg_sums: Optional[np.ndarray], stash_codes: bool
                      ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """A coded tier's install on the host: the canonical flat-order
        codes (encoded here, or the payload's) permuted into the layout
        ``row_ext``, their scales, and the rotated segment centroids. Sets
        the codebook, residual flag, rotation and centre."""
        from clipx_torch.search import codes_io

        # encoded on the host: a full f32 copy never lies on the device
        if seg_sums is None:
            seg_sums = _segment_sums(vectors, row_ext)
        if coded is None:
            if (self.pq_storage and self._pq is None
                    and pq_lib.pq_residual_enabled()):
                coded = _encode_residual_flat(
                    vectors, row_ext, seg_sums, counts, self._rot)
                self._pq = coded["codebook"]
            else:
                coded = codes_io.encode_corpus(
                    vectors, self.dtype, rot=self._rot, codebook=self._pq)
                if self.pq_storage and self._pq is None:
                    self._pq = coded["codebook"]
        elif self.pq_storage and self._pq is None:
            self._pq = pq_lib.PQCodebook(np.asarray(coded["centroids"]))
        if self.pq_storage:
            self._residual = bool(coded.get("residual"))
            if coded.get("rot_matrix") is not None:
                self._rot = coded["rot_matrix"]  # trained OPQ
        self._center = coded.get("center")  # centered int8/int4
        if stash_codes:
            self._pending_codes_payload = coded
        codes, scales = _permute_coded(coded, row_ext, live)
        # centroids in rotated space (rotation is linear)
        sums = engine.rotate_rows(
            np.ascontiguousarray(seg_sums, np.float32), self._rot)
        cent = np.ascontiguousarray(
            sums / np.maximum(counts[:, None], 1.0), np.float32)
        return codes, scales, cent

    def _index_rows(self, row_ext: np.ndarray, n: int) -> None:
        """The install's host bookkeeping: the live-occupancy sums of
        ``_probe_floor``, the row <-> external-id maps and the counts."""
        live = row_ext >= 0
        live_counts = live.reshape(-1, _SEG_W).sum(axis=1)
        self._live_count_cumsum = np.cumsum(
            np.sort(live_counts[live_counts > 0]))
        self._row_ext = row_ext.astype(np.int64)
        pos = np.flatnonzero(live)
        self._pos_of_ext = np.empty(n, np.int64)
        self._pos_of_ext[row_ext[pos]] = pos
        self._base_n = n
        self.ntotal = n + (self._tail.ntotal if self._tail else 0)

    def add(self, vectors: np.ndarray) -> None:
        """Append rows to the exact tail (ids continue from ntotal); the
        clustered base is not retrained."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) vectors, "
                             f"got {vectors.shape}")
        if vectors.shape[0] == 0:
            return
        if self._tail is None:
            # residual-pq codebooks cover residuals, not raw rows: the tail
            # stores exact f32 instead
            tail_dtype = ("f32" if self.pq_storage and self._residual
                          else self.dtype)
            self._tail = engine.VectorIndex(self.dim, dtype=tail_dtype,
                                            device=self.device)
            if (self.pq_storage and not self._residual
                    and self._pq is not None):
                # share the base codebooks and rotation
                self._tail._pq = self._pq
                self._tail._rot = self._rot
                self._tail._code_dim = self._pq.m // 2
        self._tail.add(vectors)
        self.ntotal = self._base_n + self._tail.ntotal

    @property
    def tail_fraction(self) -> float:
        t = self._tail.ntotal if self._tail else 0
        return t / max(1, self.ntotal)

    def _ensure_codes(self) -> None:
        if self._codes3 is not None:
            return
        with self._codes_lock:
            if self._codes3 is not None:
                return
            codes, scales = engine._quantize_device(
                self._corpus3.reshape(-1, self.dim))
            segs = self._corpus3.shape[0]
            # scales first: a search that sees the codes without the lock
            # also sees their scales
            self._scales2 = scales.reshape(segs, _SEG_W)
            self._codes3 = codes.reshape(segs, _SEG_W, self.dim)

    def _segs(self) -> int:
        """Segment count of the clustered base (0 when empty)."""
        arr = self._codes3 if self.coded_storage else self._corpus3
        return 0 if arr is None else arr.shape[0]

    def _probe(self, qt: torch.Tensor, P: int, kk: int):
        """One probed scan: (Q, kk) scores + INTERNAL row ids."""
        if self.pq_storage:
            return _ivf_kernel_pq(
                self._codes3, self._pq.device(self.device), self._seg_cent,
                self._valid2, qt, P, kk, residual=self._residual)
        if self.int4_storage:
            return _ivf_kernel_int4_pure(self._codes3, self._scales2,
                                         self._seg_cent, self._valid2, qt,
                                         P, kk)
        if self.int8_storage:
            return _ivf_kernel_int8_pure(self._codes3, self._scales2,
                                         self._seg_cent, self._valid2, qt,
                                         P, kk)
        if self.quantized:
            self._ensure_codes()
            return _ivf_kernel_int8(self._codes3, self._scales2,
                                    self._corpus3, self._seg_cent,
                                    self._valid2, qt, P, kk)
        return _ivf_kernel_f32(self._corpus3, self._seg_cent, self._valid2,
                               qt, P, kk)

    def probe_bucket(self, k: int, nprobe: Optional[int] = None) -> int:
        """The bucketed probe count of a (k, nprobe) request:
        ``ceil(nprobe% * segs)`` bucketed, floored so the k
        smallest-occupancy live segments still hold k rows."""
        segs = self._segs()
        if segs == 0:
            return 0
        k = clamp_k(k)
        eff = (self._nprobe if nprobe is None
               else int(np.clip(int(nprobe), 1, 100)))
        P = _bucket_probe(max(1, int(np.ceil(eff / 100.0 * segs))))
        return min(max(P, _bucket_probe(self._probe_floor(k))), segs)

    def shape_key(self, k: int, nprobe: Optional[int] = None) -> tuple:
        """(kk, P) of a (k, nprobe) search: the request-dependent shape."""
        k = clamp_k(k)
        P = self.probe_bucket(k, nprobe)
        if P == 0:
            return (engine._bucket_k(k), 0)
        return (min(engine._bucket_k(k), P * _SEG_W), P)

    # -- search ---------------------------------------------------------------
    def search(self, queries: np.ndarray, k: int, *,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """``nprobe`` overrides the index-global knob for this call only."""
        k = clamp_k(k)
        queries = np.require(np.atleast_2d(queries), np.float32, ("C", "W"))
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim} "
                "(is --model the one this index was built with?)")
        nq = queries.shape[0]
        segs = self._segs()
        if self.ntotal == 0 or segs == 0:
            if self._tail is not None and self._tail.ntotal:
                return self._tail.search(queries, k)
            return (np.full((nq, k), -np.inf, np.float32),
                    np.full((nq, k), -1, np.int64))
        P = self.probe_bucket(k, nprobe)
        qcap = _qcap(P, self.dim, self.quantized, k,
                     int8_storage=self.coded_storage,
                     pq_mk=(self._pq.m * pq_lib.PQ_K
                            if self.pq_storage else 0))
        if nq > qcap:
            parts = [self.search(queries[i: i + qcap], k, nprobe=nprobe)
                     for i in range(0, nq, qcap)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        kk = min(engine._bucket_k(k), P * _SEG_W)
        # the probe sees ROTATED queries (codes and centroids are rotated);
        # the exact tail rotates its own
        qrot = engine.rotate_rows(queries, self._rot)
        with torch.inference_mode(), full_f32(self.device):
            d, ids = self._probe(torch.from_numpy(qrot).to(self.device), P,
                                 kk)
            d = d.cpu().numpy()
            ids = ids.to(torch.int64).cpu().numpy()
        if self._center is not None:
            # centered codes scored the residual only: add the exact q·mean
            d = d + (qrot @ self._center)[:, None]
        ids_ext = np.where(np.isfinite(d), self._row_ext[ids], -1)
        if self._tail is not None and self._tail.ntotal:
            td, ti = self._tail.search(queries, k)
            ti = np.where(ti >= 0, ti + self._base_n, -1)
            d = np.concatenate([d, td], axis=1)
            ids_ext = np.concatenate([ids_ext, ti], axis=1)
            order = np.argsort(-d, axis=1, kind="stable")
            d = np.take_along_axis(d, order, axis=1)
            ids_ext = np.take_along_axis(ids_ext, order, axis=1)
        d = d[:, :k]
        ids_ext = ids_ext[:, :k]
        if d.shape[1] < k:
            pad = k - d.shape[1]
            d = np.pad(d, ((0, 0), (0, pad)), constant_values=-np.inf)
            ids_ext = np.pad(ids_ext, ((0, 0), (0, pad)),
                             constant_values=-1)
        return d, ids_ext

    # -- reconstruction -------------------------------------------------------
    def _take(self, name: str, idx: np.ndarray) -> np.ndarray:
        """Rows ``idx`` of a layout tensor, on the host: segments of
        ``_seg_cent``, row slots (segments x 64, flattened) of the others."""
        t = getattr(self, name)
        return _take_rows([t], idx, t.shape[0] if name == "_seg_cent"
                          else t.shape[0] * _SEG_W, name != "_seg_cent")

    def _decode(self, codes: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Coded rows at internal positions ``pos`` -> user-space f32."""
        if self.pq_storage:
            v = self._pq.decode(codes)
            if self._residual:  # decode is the residual only
                v = v + self._take("_seg_cent", pos // _SEG_W)
        else:
            if self.int4_storage:
                codes = engine.unpack_int4_host(codes)
            v = codes.astype(np.float32) * self._take("_scales2", pos)[:, None]
            if self._center is not None:
                v = v + self._center
        return v @ self._rot.T if self._rot is not None else v

    def _base_rows(self, pos: np.ndarray) -> np.ndarray:
        """User-space f32 rows of the clustered base at positions ``pos``."""
        if not self.coded_storage:
            return self._take("_corpus3", pos)
        return self._decode(self._take("_codes3", pos), pos)

    def reconstruct(self, row: int) -> np.ndarray:
        if not (0 <= row < self.ntotal):
            raise IndexError(row)
        if row >= self._base_n:
            return self._tail.reconstruct(row - self._base_n)
        return self._base_rows(self._pos_of_ext[row: row + 1])[0]

    def vectors(self) -> np.ndarray:
        """Rows in EXTERNAL id order (the sidecar order); coded tiers
        return decoded rows in user space."""
        pos = self._pos_of_ext if self._segs() else np.zeros((0,), np.int64)
        base = np.empty((len(pos), self.dim), np.float32)
        step = 1 << 18  # bounds the gather and decode transients
        for i in range(0, len(pos), step):
            base[i: i + step] = self._base_rows(pos[i: i + step])
        if self._tail is not None and self._tail.ntotal:
            return np.concatenate([base, self._tail.vectors()])
        return base


def _take_rows(parts, idx: np.ndarray, per: int, slots: bool) -> np.ndarray:
    """Rows ``idx`` of the concatenation of ``parts`` (``per`` rows each; a
    part's first two dims flattened when ``slots``), gathered on each part's
    device and returned on the host in the order of ``idx`` (floats as
    f32)."""
    out = None
    for j, t in enumerate(parts):
        sel = np.flatnonzero(idx // per == j)
        if not len(sel):
            continue
        flat = t.reshape(-1, *t.shape[2:]) if slots else t
        rows = flat[torch.from_numpy(idx[sel] - j * per).to(t.device)]
        if rows.is_floating_point():
            rows = rows.float()
        rows = rows.cpu().numpy()
        if out is None:
            out = np.empty((len(idx),) + rows.shape[1:], rows.dtype)
        out[sel] = rows
    return out


# ---------------------------------------------------------------------------
# layout helpers shared by the vector- and codes-install paths (numpy, the
# same code as clipx's)
# ---------------------------------------------------------------------------

def _segment_sums(vectors, row_ext: np.ndarray,
                  chunk_segs: int = 8192) -> np.ndarray:
    """Per-segment row sums in UNROTATED user space, (segs, D) f32 — the
    coarse-quantizer numerator. Chunked over segments so a memmapped corpus
    never materializes a full padded copy."""
    segs = len(row_ext) // _SEG_W
    dim = vectors.shape[1]
    sums = np.empty((segs, dim), np.float32)
    for s0 in range(0, segs, chunk_segs):
        s1 = min(segs, s0 + chunk_segs)
        re = row_ext[s0 * _SEG_W: s1 * _SEG_W]
        lv = re >= 0
        rows = np.zeros((len(re), dim), np.float32)
        rows[lv] = vectors[re[lv]]
        sums[s0:s1] = rows.reshape(s1 - s0, _SEG_W, dim).sum(axis=1)
    return sums


def _permute_coded(coded: dict, row_ext: np.ndarray, live: np.ndarray,
                   step: int = 1 << 20
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Scatter canonical flat-order codes (and scales) into the padded
    cluster layout: zero codes / 1e-12 scales on dead rows. Chunked so a
    memmapped codes file never doubles in RAM."""
    codes_flat = coded["codes"]
    cdim = codes_flat.shape[1]
    rows = len(row_ext)
    pc = np.zeros((rows, cdim), np.int8)
    scales_flat = coded["scales"]
    ps = (np.full((rows,), 1e-12, np.float32)
          if scales_flat is not None else None)
    pos = np.flatnonzero(live)
    ext = row_ext[pos]
    for i in range(0, len(pos), step):
        p = pos[i: i + step]
        e = ext[i: i + step]
        pc[p] = np.asarray(codes_flat[e])
        if ps is not None:
            ps[p] = np.asarray(scales_flat[e])
    return pc, ps


def _encode_residual_flat(vectors, row_ext: np.ndarray,
                          seg_sums: np.ndarray, counts: np.ndarray,
                          rot: Optional[np.ndarray]) -> dict:
    """Residual-PQ encoding in flat EXTERNAL row order (faiss
    ``by_residual``): residual_i = x_i - cent[seg(i)], formed unrotated so
    OPQ trains on the residuals themselves; the rotation runs inside
    encode (rot(x) - rot(c) = (x - c) @ rot). Codebooks train on a seeded
    residual sample; codes chunk over a possibly-memmapped ``vectors``."""
    counts_f = np.maximum(np.asarray(counts, np.float32), 1.0)
    cent_unrot = (np.ascontiguousarray(seg_sums, np.float32)
                  / counts_f[:, None])
    live = row_ext >= 0
    pos = np.flatnonzero(live)
    n = len(pos)
    seg_of_ext = np.empty(n, np.int64)
    seg_of_ext[row_ext[pos]] = pos // _SEG_W
    rng = np.random.default_rng(pq_lib._PQ_SEED + vectors.shape[1])
    if n > pq_lib._PQ_TRAIN_SAMPLE:
        idx = rng.choice(n, pq_lib._PQ_TRAIN_SAMPLE, replace=False)
    else:
        idx = np.arange(n)
    res = (np.ascontiguousarray(vectors[idx], np.float32)
           - cent_unrot[seg_of_ext[idx]])
    rot, cb = pq_lib.train_opq(res, rot)
    codes = np.empty((n, cb.m // 2), np.int8)
    step = 1 << 16
    for i in range(0, n, step):
        b = (np.asarray(vectors[i: i + step], np.float32)
             - cent_unrot[seg_of_ext[i: i + step]])
        codes[i: i + len(b)] = cb.encode(b, rot=rot)
    return {"codes": codes, "scales": None, "centroids": cb.centroids,
            "codebook": cb, "rot_matrix": rot, "residual": True}


def layout_digest(layout: np.ndarray) -> bytes:
    """Identity digest of a cluster layout (the .ivf cache's int32
    ``layout``). Residual-PQ codes are encoded against the segment
    centroids a layout induces; the codes file records this digest so codes
    never decode against another clustering."""
    return hashlib.blake2b(np.ascontiguousarray(layout, np.int32).tobytes(),
                           digest_size=16).digest()


def _layout_ok(layout: np.ndarray, n: int) -> bool:
    live = layout[layout >= 0]
    return not (len(layout) % _SEG_W or len(live) != n
                or (np.sort(live) != np.arange(n)).any())


# ---------------------------------------------------------------------------
# the .ivf cache (clipx's v2 format): layout + per-segment sums, keyed by
# the content hash of the f32 rows
# ---------------------------------------------------------------------------

_CACHE_VERSION = 2


def _fingerprint(vectors: np.ndarray) -> bytes:
    return engine.content_hash(vectors)


def _save_cache(path: str, vectors: np.ndarray, layout: np.ndarray) -> None:
    tmp = path + ".tmp"
    np.savez(tmp, version=_CACHE_VERSION,
             fp=np.frombuffer(_fingerprint(vectors), dtype=np.uint8),
             layout=layout.astype(np.int32),
             sums=_segment_sums(vectors, layout))
    # np.savez appends .npz to the name it opens
    os.replace(tmp + ".npz", path)


def _load_cache(path: str, vectors: np.ndarray) -> Optional[np.ndarray]:
    try:
        with np.load(path) as z:
            if int(z["version"]) != _CACHE_VERSION:
                return None
            if z["fp"].tobytes() != _fingerprint(vectors):
                return None
            layout = z["layout"].astype(np.int64)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None  # unreadable or foreign file: the caller retrains
    if not _layout_ok(layout, vectors.shape[0]):
        return None
    return layout


def _load_cache_for_codes(path: str, payload: dict
                          ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Validate the .ivf cache against a codes-file payload without the f32
    rows: the cache's fingerprint and the codes file's content hash must be
    equal, and residual payloads must carry the cache layout's digest.
    Returns (layout, sums) or None (the caller rebuilds from f32)."""
    ch = payload.get("content_hash")
    if not ch or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["version"]) != _CACHE_VERSION:
                return None
            if z["fp"].tobytes() != ch:
                return None
            layout = z["layout"].astype(np.int64)
            sums = np.asarray(z["sums"], np.float32)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None
    if payload.get("residual"):
        ld = payload.get("layout_digest")
        if ld is None or ld != layout_digest(layout):
            return None
    if not _layout_ok(layout, payload["ntotal"]):
        return None
    if sums.shape != (len(layout) // _SEG_W, payload["dim"]):
        return None
    return layout, sums


# ---------------------------------------------------------------------------
# the corpus-sharded IVF index
# ---------------------------------------------------------------------------

class ShardedIVFIndex(IVFIndex):
    """IVF with the segment list row-sharded over a 1-D ``"shard"`` mesh
    (clipx's ``ShardedIVFIndex``).

    Segments are dealt ROUND-ROBIN to shards (shard j holds the layout's
    segments j, j+n, j+2n, ...; cached segment sums follow the deal).
    Clusters occupy contiguous segment runs, so the deal spreads every
    cluster ~evenly across shards, which makes the probe rule sound: each
    shard probes its LOCAL top ceil(P/n) segments (bucketed), and the union
    tracks the global top P a single device would pick. At ``nprobe=100``
    every shard probes everything: the f32 ranking is the single-device
    one, and the quantized tiers rescore a superset of the single-device
    segment pool (min(kk, P/n) a shard against min(kk, P)). Global ids are
    (segment + shard * S_local) * 64 + slot, mapped back through the dealt
    ``row_ext``. Each shard's (Q, k) candidates merge as in
    ``parallel/mips.py``; the pq tiers scan each shard's probed segments
    with the PQ kernel (``_pq_probe_body``).

    ``add`` is inherited: appended rows go to the exact tail on the first
    device until the next full rebuild re-clusters them."""

    def __init__(self, dim: int, quantized: bool = False, dtype: str = "f32",
                 device=None, mesh=None):
        from clipx_torch.parallel.mesh import visible_devices
        from clipx_torch.parallel.mips import AXIS, shard_mesh

        if mesh is None:
            mesh = shard_mesh(None if device is None
                              else visible_devices(device))
        if AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a {AXIS!r} axis")
        self.mesh = mesh
        self._n_shards = mesh.shape[AXIS]
        self._local = mesh.local_positions()
        self._devices = [mesh.devices[j] for j in self._local]
        super().__init__(dim, quantized=quantized, dtype=dtype,
                         device=self._devices[0])
        self._seg_valid = None
        self._segs_total = 0

    def _segs(self) -> int:
        return self._segs_total

    def _install(self, vectors: Optional[np.ndarray], row_ext: np.ndarray, *,
                 coded: Optional[dict] = None,
                 seg_sums: Optional[np.ndarray] = None,
                 stash_codes: bool = False) -> None:
        n_rows = coded["ntotal"] if vectors is None else vectors.shape[0]
        n = self._n_shards
        segs = max(1, len(row_ext) // _SEG_W)
        segs_pad = -(-segs // n) * n
        if segs_pad * _SEG_W > len(row_ext):
            row_ext = np.concatenate([
                row_ext,
                np.full(segs_pad * _SEG_W - len(row_ext), -1, np.int64)])
        # deal segments round-robin: contiguous shard block j ends up
        # holding the layout's segments [j::n]
        perm = np.arange(segs_pad).reshape(-1, n).T.reshape(-1)
        row_ext = row_ext.reshape(segs_pad, _SEG_W)[perm].reshape(-1)
        if seg_sums is not None:
            # canonical segment order in, dealt order out; the alignment
            # segments are all-dead, their sums zero
            s = np.zeros((segs_pad, seg_sums.shape[1]), np.float32)
            s[: seg_sums.shape[0]] = seg_sums
            seg_sums = s[perm]
        live = row_ext >= 0
        valid2 = live.reshape(segs_pad, _SEG_W)
        counts = valid2.sum(axis=1).astype(np.float32)
        s_loc = segs_pad // n

        def shard(a, j):  # shard j's block of a segment-major host array
            return torch.from_numpy(np.ascontiguousarray(
                a[j * s_loc: (j + 1) * s_loc]))

        places = list(zip(self._local, self._devices))
        if self.coded_storage:
            codes, scales, cent = self._coded_layout(
                vectors, row_ext, live, counts, coded, seg_sums, stash_codes)
            codes = codes.reshape(segs_pad, _SEG_W, codes.shape[1])
            self._corpus3 = None
            self._codes3 = [shard(codes, j).to(d) for j, d in places]
            self._scales2 = (None if scales is None else [
                shard(scales.reshape(segs_pad, _SEG_W), j).to(d)
                for j, d in places])
            self._seg_cent = [shard(cent, j).to(d) for j, d in places]
        else:
            # one shard at a time: the host holds one padded shard
            self._corpus3, self._seg_cent = [], []
            for j, dev in places:
                re = row_ext[j * s_loc * _SEG_W: (j + 1) * s_loc * _SEG_W]
                lv = re >= 0
                padded = np.zeros((len(re), self.dim), np.float32)
                padded[lv] = vectors[re[lv]]
                c3 = torch.from_numpy(padded.reshape(
                    s_loc, _SEG_W, self.dim)).to(dev).to(self._store_dtype())
                self._corpus3.append(c3)
                self._seg_cent.append(
                    _segment_stats(c3, shard(counts, j).to(dev)))
            self._codes3 = None
            self._scales2 = None
        self._valid2 = [shard(valid2, j).to(d) for j, d in places]
        # fully-dead alignment segments exist here (unlike the single-device
        # layout): they are masked out of the coarse scoring
        self._seg_valid = [shard(valid2.any(axis=1), j).to(d)
                           for j, d in places]
        self._segs_total = segs_pad
        self._index_rows(row_ext, n_rows)

    def _ensure_codes(self) -> None:
        if self._codes3 is not None:
            return
        with self._codes_lock:
            if self._codes3 is not None:
                return
            codes, scales = [], []
            for c3 in self._corpus3:
                c, sc = engine._quantize_device(c3.reshape(-1, self.dim))
                scales.append(sc.reshape(c3.shape[0], _SEG_W))
                codes.append(c.reshape(c3.shape))
            # scales first: a search that sees the codes without the lock
            # also sees their scales
            self._scales2 = scales
            self._codes3 = codes

    def _take(self, name: str, idx: np.ndarray) -> np.ndarray:
        per = self._segs_total // self._n_shards
        if name != "_seg_cent":
            per *= _SEG_W
        held = np.isin(idx // per, self._local)
        if not held.all():
            raise ValueError("rows of a sharded IVF index held by another "
                             "process cannot be read here")
        # this process's shards are a contiguous run of the mesh
        first = self._local[0] * per
        return _take_rows(getattr(self, name), idx - first, per,
                          name != "_seg_cent")

    def _probe(self, qt: torch.Tensor, P: int, kk: int):
        """Each shard probes its local top P_local segments; the (Q, kk)
        candidates merge across shards (global internal ids)."""
        from clipx_torch.parallel.mips import _merge_across_shards

        s_loc = self._segs_total // self._n_shards
        p_loc = min(_bucket_probe(-(-P // self._n_shards)), s_loc)
        kk_loc = min(kk, p_loc * _SEG_W)
        s = min(kk, p_loc)
        if self.quantized and not self.coded_storage:
            self._ensure_codes()
        on = {}
        parts = []
        for j, dev in enumerate(self._devices):
            if dev not in on:
                on[dev] = qt.to(dev)
            q = on[dev]
            cvals, seg_idx = _coarse(q, self._seg_cent[j], p_loc,
                                     self._seg_valid[j])
            v2 = self._valid2[j]
            if self.pq_storage:
                d, ids = _pq_probe_body(
                    self._codes3[j], self._pq.device(dev), v2, q, seg_idx,
                    kk_loc, seg_scores=cvals if self._residual else None)
            elif self.int4_storage:
                packed, sc = self._codes3[j], self._scales2[j]
                d, ids = _int8_probe_body(
                    packed, sc, v2, q, seg_idx,
                    _dequant_rows_int4(packed, sc), s, kk_loc,
                    scan_raw=_scan_raw_int4(packed))
            elif self.int8_storage:
                codes, sc = self._codes3[j], self._scales2[j]
                d, ids = _int8_probe_body(codes, sc, v2, q, seg_idx,
                                          _dequant_rows(codes, sc), s,
                                          kk_loc)
            elif self.quantized:
                c3 = self._corpus3[j]
                d, ids = _int8_probe_body(
                    self._codes3[j], self._scales2[j], v2, q, seg_idx,
                    lambda chosen, c3=c3: c3[chosen].float(), s, kk_loc)
            else:
                d, ids = _f32_probe_body(self._corpus3[j], v2, q, seg_idx,
                                         kk_loc)
            parts.append((d, ids + self._local[j] * s_loc * _SEG_W))
        return _merge_across_shards(parts, kk, self.mesh)
