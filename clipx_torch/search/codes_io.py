"""The ``<index>.codes`` file: coded-index persistence.

Counterpart of ``clipx/search/codes_io.py``, writing and reading the same
bytes: a port-written file equals a clipx-written one for the same sidecar
and tier, and each package loads the other's. The coded tiers
(``--corpus-dtype int8/int4/pq``) write their codes (+ scales and centre,
or codebooks and OPQ rotation) once, and later starts load them directly:
no f32 read, quantization or PQ training.

File format (little-endian)::

    magic  b"CLIPXCOD1\\n"                      (10 B)
    u32    meta_len                              (4 B)
    16 B   fp_sample      sampled f32-sidecar fingerprint
    16 B   content_hash   full blake2b of the f32 rows (zero = absent)
    meta_len B  JSON metadata (tier, ntotal, dim, code_dim, rotated,
                dsub, flags)
    raw sections, in order: codes, then scales (+ centre) for int8/int4,
                or centroids (+ OPQ rotation) for pq
    footer  b"CXSELF1\\0" | self_fp_sample (16) | self_full_hash (16)

Codes are stored in sidecar row order and in rotated space, exactly what
an in-memory coded build places. Staleness: with the f32 sidecar present,
``fp_sample`` (its header plus first and last ``_FP_SAMPLE_ROWS`` rows)
must match (``CLIPX_CODES_VERIFY=full`` hashes the whole sidecar, ``off``
skips the check). With the sidecar absent (codes-only boot), the file is
checked against its own footer instead.

``encode_corpus`` is THE coded-tier encoder: a flat index's first add and
the codes-file writer both go through it, so the bytes on disk and the
bytes a fresh build places are the same array.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Optional, Tuple

import numpy as np

_MAGIC = b"CLIPXCOD1\n"
_VERSION = 1
_FP_SAMPLE_ROWS = 65536
# rows per encode chunk — must match engine.quantize_rows_rotated's
# internal chunking (1 << 18) so chunk-wise encoding reproduces the
# one-call result bit-for-bit (BLAS blocking depends on operand shape)
_ENC_CHUNK = 1 << 18
# pq encode outer chunk — matches PQCodebook.encode's internal chunk
_PQ_ENC_CHUNK = 1 << 16

_TIERS = ("int8", "int4", "pq")
_HDR_FIXED = len(_MAGIC) + 4 + 16 + 16
_ZERO16 = b"\x00" * 16
# self-integrity footer (codes-only deployment): appended after the
# last section — magic + sampled payload fp + full payload hash
_SELF_MAGIC = b"CXSELF1\x00"
_SELF_LEN = len(_SELF_MAGIC) + 16 + 16


def codes_path(index_path: str) -> str:
    return index_path + ".codes"


def tier_of(dtype: str) -> Optional[str]:
    """Map a --corpus-dtype name to its codes-file tier tag (None for the
    uncoded f32/bf16 tiers, which need no codes file)."""
    return dtype if dtype in _TIERS else None


def tier_of_name(name: str) -> Optional[str]:
    """A --corpus-dtype name's codes-file tier tag, for the entry points'
    pre-checks before any device work (``tier_of`` under clipx's name)."""
    return tier_of(name)


def codes_mode() -> str:
    """$CLIPX_CODES: 'on' (default — load fresh codes, write them after
    a fallback f32 build), 'off' (never read or write), 'refresh'
    (ignore any existing file, rebuild from f32 and rewrite)."""
    v = os.environ.get("CLIPX_CODES", "on").lower()
    return v if v in ("on", "off", "refresh") else "on"


def _verify_mode() -> str:
    v = os.environ.get("CLIPX_CODES_VERIFY", "sample").lower()
    return v if v in ("sample", "full", "off") else "sample"


# ---------------------------------------------------------------------------
# f32-sidecar fingerprints
# ---------------------------------------------------------------------------

def sidecar_sample_fp(index_path: str,
                      sample_rows: Optional[int] = None
                      ) -> Optional[bytes]:
    """Sampled fingerprint of the f32 sidecar: header + first and last
    ``sample_rows`` (default ``_FP_SAMPLE_ROWS``) rows — bounded IO at
    any corpus size. None when the sidecar is missing or malformed."""
    from clipx_torch.search.engine import _MAGIC as IDX_MAGIC

    if sample_rows is None:
        sample_rows = _FP_SAMPLE_ROWS
    try:
        with open(index_path, "rb") as f:
            if f.read(len(IDX_MAGIC)) != IDX_MAGIC:
                return None
            hdr = f.read(16)
            if len(hdr) != 16:
                return None
            ntotal, dim = struct.unpack("<qq", hdr)
            if not (0 <= ntotal and 0 < dim <= 65536):
                return None
            h = hashlib.blake2b(digest_size=16)
            h.update(struct.pack("<qq", ntotal, dim))
            row = dim * 4
            head = min(ntotal, sample_rows)
            data = f.read(head * row)
            if len(data) != head * row:
                return None
            h.update(data)
            if ntotal > sample_rows:
                f.seek(len(IDX_MAGIC) + 16 + (ntotal - sample_rows) * row)
                tail = f.read(sample_rows * row)
                if len(tail) != sample_rows * row:
                    return None
                h.update(tail)
            return h.digest()
    except OSError:
        return None


def sidecar_full_hash(index_path: str,
                      chunk_bytes: int = 1 << 26) -> Optional[bytes]:
    """Full engine.content_hash of the sidecar rows, streamed from disk
    (the CLIPX_CODES_VERIFY=full path — one sequential read, no RAM
    spike)."""
    from clipx_torch.search.engine import _MAGIC as IDX_MAGIC

    try:
        with open(index_path, "rb") as f:
            if f.read(len(IDX_MAGIC)) != IDX_MAGIC:
                return None
            ntotal, dim = struct.unpack("<qq", f.read(16))
            if not (0 <= ntotal and 0 < dim <= 65536):
                return None
            h = hashlib.blake2b(digest_size=16)
            left = ntotal * dim * 4
            while left:
                data = f.read(min(left, chunk_bytes))
                if not data:
                    return None
                h.update(data)
                left -= len(data)
            return h.digest()
    except OSError:
        return None


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class CodesWriter:
    """Streaming codes-file writer: header first (sizes are known from
    ``ntotal``), code rows streamed in external order, trailing
    sections (scales / centroids) and the fingerprint slots written on
    ``close()``. Atomic: data lands in ``path + '.tmp'`` and renames
    into place; abandoning the writer leaves any previous file intact."""

    def __init__(self, path: str, *, tier: str, ntotal: int, dim: int,
                 code_dim: int, rotated: bool,
                 fp_sample: Optional[bytes],
                 dsub: Optional[int] = None, opq: bool = False,
                 residual: bool = False,
                 layout_digest: Optional[bytes] = None,
                 verify_sidecar: Optional[str] = None,
                 center: Optional[np.ndarray] = None):
        if tier not in _TIERS:
            raise ValueError(f"unknown tier {tier!r}")
        if tier == "pq" and dsub not in (2, 4):
            raise ValueError(f"pq tier needs dsub 2 or 4, got {dsub}")
        self._path = path
        self._tmp = path + ".tmp"
        self._tier = tier
        self._code_dim = code_dim
        self._dim = dim
        self._ntotal = ntotal
        self._remaining = ntotal
        self._need_scales = tier in ("int8", "int4")
        self._scales = [] if self._need_scales else None
        self._centroids: Optional[np.ndarray] = None
        self._rotation: Optional[np.ndarray] = None
        if center is not None and tier not in ("int8", "int4"):
            raise ValueError("only int8/int4 codes carry a center")
        self._center = (None if center is None
                        else np.ascontiguousarray(center, np.float32))
        if self._center is not None and self._center.shape != (dim,):
            raise ValueError(f"center must be ({dim},), "
                             f"got {self._center.shape}")
        self._content_hash: Optional[bytes] = None
        # TOCTOU guard: the caller captured fp_sample
        # when it OPENED the f32 memmap; if verify_sidecar is given,
        # close() re-samples that path and aborts on mismatch — a
        # sidecar replaced mid-encode must not get codes of the old
        # rows stamped with the new file's fingerprint.
        self._fp_expected = fp_sample
        self._verify_sidecar = verify_sidecar
        self.opq = bool(opq)
        meta = {
            "version": _VERSION,
            "tier": tier,
            "ntotal": int(ntotal),
            "dim": int(dim),
            "code_dim": int(code_dim),
            "rotated": bool(rotated),
            # self-integrity footer present (codes-only deployment)
            "self": 1,
        }
        if dsub is not None:
            meta["dsub"] = int(dsub)
        if self.opq:
            # trained OPQ rotation (pq.train_opq): a (dim, dim) f32
            # section follows the centroids, and loaders MUST use it in
            # place of the seed-derived fixed rotation
            meta["opq"] = True
        if residual:
            # pq codes are RESIDUALS vs the IVF segment centroids
            # (faiss by_residual): only loadable under --search-mode
            # ivf with the v2 .ivf cache whose fp matches content_hash
            meta["residual"] = True
        if self._center is not None:
            # int8/int4 codes are residuals from the rotated-space
            # corpus mean (engine.coded_center_enabled): a f32[dim]
            # section follows the scales, and scores add q·mean back
            meta["centered"] = True
        if layout_digest is not None:
            # residual codes are LAYOUT-dependent (encoded against
            # segment centroids), and k-means layouts are only
            # deterministic per platform: bind the codes to the exact
            # .ivf layout they were encoded under
            meta["layout_digest"] = layout_digest.hex()
        blob = json.dumps(meta, sort_keys=True).encode()
        # self-integrity: full hash covers meta blob + every section
        # byte; the sampled fp covers meta blob + head/tail code rows
        # (+ head/tail scales) + the small trailing sections — bounded
        # IO at any corpus size, mirroring sidecar_sample_fp
        self._self_full = hashlib.blake2b(digest_size=16)
        self._self_sample = hashlib.blake2b(digest_size=16)
        self._self_full.update(blob)
        self._self_sample.update(blob)
        self._head_left = min(ntotal, _FP_SAMPLE_ROWS) * code_dim
        self._tail_cap = (_FP_SAMPLE_ROWS * code_dim
                          if ntotal > _FP_SAMPLE_ROWS else 0)
        self._tail_buf = bytearray()
        self._f = open(self._tmp, "wb")
        self._f.write(_MAGIC)
        self._f.write(struct.pack("<I", len(blob)))
        self._f.write(fp_sample if fp_sample else _ZERO16)
        self._f.write(_ZERO16)  # content_hash patched on close
        self._f.write(blob)

    def write_codes(self, codes: np.ndarray,
                    scales: Optional[np.ndarray] = None) -> None:
        codes = np.ascontiguousarray(codes, np.int8)
        if codes.ndim != 2 or codes.shape[1] != self._code_dim:
            raise ValueError(f"expected (n, {self._code_dim}) codes, "
                             f"got {codes.shape}")
        if codes.shape[0] > self._remaining:
            raise ValueError("wrote past the declared ntotal")
        if self._need_scales:
            if scales is None or scales.shape[0] != codes.shape[0]:
                raise ValueError("int8/int4 codes need matching scales")
            self._scales.append(np.ascontiguousarray(scales, np.float32))
        raw = codes.tobytes()
        self._self_full.update(raw)
        if self._head_left:
            take = min(self._head_left, len(raw))
            self._self_sample.update(raw[:take])
            self._head_left -= take
        if self._tail_cap:
            self._tail_buf += raw
            if len(self._tail_buf) > self._tail_cap:
                del self._tail_buf[: len(self._tail_buf) - self._tail_cap]
        self._f.write(raw)
        self._remaining -= codes.shape[0]

    def set_centroids(self, centroids: np.ndarray) -> None:
        self._centroids = np.ascontiguousarray(centroids, np.float32)

    def set_rotation(self, rot: np.ndarray) -> None:
        if rot.shape != (self._dim, self._dim):
            raise ValueError(f"rotation must be ({self._dim}, "
                             f"{self._dim}), got {rot.shape}")
        self._rotation = np.ascontiguousarray(rot, np.float32)

    def set_content_hash(self, digest: Optional[bytes]) -> None:
        self._content_hash = digest

    def close(self) -> None:
        if self._remaining:
            self._f.close()
            os.unlink(self._tmp)
            raise ValueError(f"codes incomplete: {self._remaining} rows "
                             "were never written")
        if self._tail_cap and self._tail_buf:
            self._self_sample.update(bytes(self._tail_buf))
        if self._need_scales:
            scal = (np.concatenate(self._scales) if self._scales
                    else np.zeros((0,), np.float32))
            raw = scal.tobytes()
            self._f.write(raw)
            self._self_full.update(raw)
            h = min(self._ntotal, _FP_SAMPLE_ROWS)
            self._self_sample.update(scal[:h].tobytes())
            if self._ntotal > _FP_SAMPLE_ROWS:
                self._self_sample.update(
                    scal[-_FP_SAMPLE_ROWS:].tobytes())
            if self._center is not None:
                raw = self._center.tobytes()
                self._f.write(raw)
                self._self_full.update(raw)
                self._self_sample.update(raw)
        if self._tier == "pq":
            if self._centroids is None:
                self._f.close()
                os.unlink(self._tmp)
                raise ValueError("pq codes need centroids "
                                 "(set_centroids)")
            raw = self._centroids.tobytes()
            self._f.write(raw)
            self._self_full.update(raw)
            self._self_sample.update(raw)
            if self.opq:
                if self._rotation is None:
                    self._f.close()
                    os.unlink(self._tmp)
                    raise ValueError("opq codes need the trained "
                                     "rotation (set_rotation)")
                raw = self._rotation.tobytes()
                self._f.write(raw)
                self._self_full.update(raw)
                self._self_sample.update(raw)
        self._f.write(_SELF_MAGIC + self._self_sample.digest()
                      + self._self_full.digest())
        if self._content_hash:
            self._f.seek(len(_MAGIC) + 4 + 16)
            self._f.write(self._content_hash)
        if self._verify_sidecar is not None:
            # TOCTOU abort: the sidecar was replaced while we encoded —
            # these codes describe the OLD rows, so stamping them with
            # the CURRENT fingerprint would serve a stale corpus as
            # fresh forever
            now = sidecar_sample_fp(self._verify_sidecar)
            if now != self._fp_expected:
                self._f.close()
                os.unlink(self._tmp)
                raise StaleSidecarError(
                    f"{self._verify_sidecar} changed during the encode; "
                    "codes discarded (rerun to encode the new rows)")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self._path)


class StaleSidecarError(ValueError):
    """The f32 sidecar was atomically replaced between the memmap open
    and the codes-file close — the encoded codes describe rows that no
    longer exist. Callers fall back to serving from RAM; the next start
    re-encodes against the new sidecar."""


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _verify_self(path: str, *, meta_len: int, data_off: int, need: int,
                 tier: str, ntotal: int, code_dim: int,
                 mode: str) -> bool:
    """Check the codes file against its own self-integrity footer
    (codes-only boot — no f32 sidecar to verify against). ``mode`` is
    'sample' (meta + head/tail code rows + head/tail scales + trailing
    sections — bounded IO) or 'full' (every payload byte). Returns
    False on a missing/mismatched footer."""
    try:
        size = os.path.getsize(path)
        if size < need + _SELF_LEN:
            return False
        with open(path, "rb") as f:
            f.seek(need)
            footer = f.read(_SELF_LEN)
            if footer[: len(_SELF_MAGIC)] != _SELF_MAGIC:
                return False
            want_sample = footer[len(_SELF_MAGIC): len(_SELF_MAGIC) + 16]
            want_full = footer[len(_SELF_MAGIC) + 16:]
            h = hashlib.blake2b(digest_size=16)
            f.seek(_HDR_FIXED)
            h.update(f.read(meta_len))
            if mode == "full":
                left = need - data_off
                f.seek(data_off)
                while left:
                    chunk = f.read(min(left, 1 << 26))
                    if not chunk:
                        return False
                    h.update(chunk)
                    left -= len(chunk)
                return h.digest() == want_full
            head = min(ntotal, _FP_SAMPLE_ROWS)
            f.seek(data_off)
            h.update(f.read(head * code_dim))
            if ntotal > _FP_SAMPLE_ROWS:
                f.seek(data_off + (ntotal - _FP_SAMPLE_ROWS) * code_dim)
                h.update(f.read(_FP_SAMPLE_ROWS * code_dim))
            off = data_off + ntotal * code_dim
            if tier in ("int8", "int4"):
                f.seek(off)
                h.update(f.read(head * 4))
                if ntotal > _FP_SAMPLE_ROWS:
                    f.seek(off + (ntotal - _FP_SAMPLE_ROWS) * 4)
                    h.update(f.read(_FP_SAMPLE_ROWS * 4))
                off += ntotal * 4
            f.seek(off)
            h.update(f.read(need - off))
            return h.digest() == want_sample
    except OSError:
        return False


def _read_meta(path: str):
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            return None
        (meta_len,) = struct.unpack("<I", f.read(4))
        if meta_len > 1 << 20:
            return None
        fp_sample = f.read(16)
        content_hash = f.read(16)
        try:
            meta = json.loads(f.read(meta_len))
        except ValueError:
            return None
    return meta, fp_sample, content_hash, _HDR_FIXED + meta_len


def load_codes(index_path: str, tier: str, *,
               rotated: bool, orphan: bool = False) -> Optional[dict]:
    """Load ``<index>.codes`` when present, structurally sound, tier-
    and rotation-matched, and fresh against the current f32 sidecar.
    Returns a payload dict (codes/scales as read-only memmaps — nothing
    large is materialized until placement) or None, in which case the
    caller falls back to re-encoding from f32.

    ``orphan=True`` is the codes-only boot (the f32 sidecar is absent,
    so there is nothing to verify freshness against): the file verifies
    against its OWN self-integrity footer instead, per
    ``CLIPX_CODES_VERIFY`` (sample/full/off). A file written
    without a footer still loads, with a warning — regenerate to get
    integrity checking.

    ``dsub`` is NOT matched against the environment: like faiss, an
    existing coded index keeps the subspace width its codebooks were
    trained with (search/pq.py, ``pq_dsub``)."""
    path = codes_path(index_path)
    if not os.path.exists(path):
        return None
    try:
        parsed = _read_meta(path)
        if parsed is None:
            return None
        meta, fp_sample, content_hash, data_off = parsed
        if meta.get("version") != _VERSION or meta.get("tier") != tier:
            return None
        if bool(meta.get("rotated")) != bool(rotated):
            return None
        ntotal, dim = int(meta["ntotal"]), int(meta["dim"])
        code_dim = int(meta["code_dim"])
        if ntotal < 0 or not (0 < dim <= 65536) or code_dim <= 0:
            return None
        # tier-specific shape consistency: a corrupted
        # meta must fail HERE into the graceful None-fallback, not
        # later as an opaque shape error
        if tier == "int8" and code_dim != dim:
            return None
        if tier == "int4" and (dim % 2 or code_dim != dim // 2):
            return None
        verify = _verify_mode()
        if not orphan:
            if verify == "full":
                if (content_hash == _ZERO16
                        or sidecar_full_hash(index_path) != content_hash):
                    return None
            elif verify == "sample":
                if (fp_sample == _ZERO16
                        or sidecar_sample_fp(index_path) != fp_sample):
                    return None
        size = os.path.getsize(path)
        need = data_off + ntotal * code_dim
        if tier in ("int8", "int4"):
            need += ntotal * 4
        dsub = None
        m = 0
        opq = bool(meta.get("opq"))
        residual = bool(meta.get("residual"))
        if residual and tier != "pq":
            return None  # only pq supports residual encoding
        centered = bool(meta.get("centered"))
        if centered and tier not in ("int8", "int4"):
            return None  # only int8/int4 carry a corpus-mean center
        if tier in ("int8", "int4"):
            from clipx_torch.search.engine import coded_center_enabled

            if centered != coded_center_enabled():
                # same policy as the rotation knob: flipping
                # CLIPX_CODED_CENTER re-encodes rather than serving
                # codes whose scoring model doesn't match the request
                return None
            if centered:
                need += dim * 4
        if tier == "pq":
            dsub = int(meta.get("dsub", 0))
            if dsub not in (2, 4) or dim % (2 * dsub):
                return None
            m = dim // dsub
            if code_dim != m // 2:
                return None
            from clipx_torch.search.pq import PQ_K

            need += m * PQ_K * dsub * 4
            if opq:
                need += dim * dim * 4
        elif opq:
            return None  # only pq carries a trained rotation
        if size < need:
            return None
        if orphan and verify != "off":
            if meta.get("self"):
                if not _verify_self(path, meta_len=data_off - _HDR_FIXED,
                                    data_off=data_off, need=need,
                                    tier=tier, ntotal=ntotal,
                                    code_dim=code_dim, mode=verify):
                    return None
            else:
                import sys

                print(f"WARNING: {path} predates the self-integrity "
                      "footer — codes-only boot proceeds UNVERIFIED "
                      "(rebuild once with the f32 sidecar present to "
                      "add it)", file=sys.stderr, flush=True)
        codes = np.memmap(path, np.int8, "r", offset=data_off,
                          shape=(ntotal, code_dim))
        ld = meta.get("layout_digest")
        payload = {
            "tier": tier, "ntotal": ntotal, "dim": dim,
            "code_dim": code_dim, "rotated": bool(meta.get("rotated")),
            "codes": codes, "scales": None, "centroids": None,
            "dsub": dsub, "rot_matrix": None, "residual": residual,
            "content_hash": (None if content_hash == _ZERO16
                             else content_hash),
            "layout_digest": bytes.fromhex(ld) if ld else None,
            "center": None,
        }
        off = data_off + ntotal * code_dim
        if tier in ("int8", "int4"):
            payload["scales"] = np.memmap(path, np.float32, "r",
                                          offset=off, shape=(ntotal,))
            if centered:
                cmm = np.memmap(path, np.float32, "r",
                                offset=off + ntotal * 4, shape=(dim,))
                payload["center"] = np.asarray(cmm)  # tiny
        else:
            from clipx_torch.search.pq import PQ_K

            cent = np.memmap(path, np.float32, "r", offset=off,
                             shape=(m, PQ_K, dsub))
            payload["centroids"] = np.asarray(cent)  # tiny — materialize
            if opq:
                off += m * PQ_K * dsub * 4
                r = np.memmap(path, np.float32, "r", offset=off,
                              shape=(dim, dim))
                payload["rot_matrix"] = np.asarray(r)
        return payload
    except (OSError, ValueError, KeyError):
        return None


# ---------------------------------------------------------------------------
# canonical encoder
# ---------------------------------------------------------------------------

def encode_corpus(vectors, tier: str, *, rot=None, codebook=None,
                  on_chunk=None, center=None) -> dict:
    """THE coded-tier encoder: flat-order host encoding of ``vectors``
    (an ndarray or sidecar memmap — access is chunked, so a memmapped
    100M-row corpus never fully materializes in RAM).

    Chunk boundaries are fixed (``_ENC_CHUNK`` / ``_PQ_ENC_CHUNK``,
    from offset 0) so every caller — the codes-file writer, the flat
    index's first add, the IVF install — produces bit-identical codes:
    BLAS rotation results depend on operand shape, so the chunking IS
    part of the canonical definition.

    Returns {codes, scales, centroids, codebook, rot_matrix};
    ``on_chunk(codes, scales)`` (when given) streams each chunk out
    instead of assembling the full codes array (the capacity-scale
    file-writing path), and the returned dict then carries codes=None.

    For pq, ``rot`` is the STARTING rotation: unless a pre-trained
    ``codebook`` is supplied (whose caller already owns the matching
    rotation), OPQ training (pq.train_opq, $CLIPX_PQ_OPQ) may replace
    it — ``rot_matrix`` in the returned payload is the EFFECTIVE
    rotation the codes were encoded under, and every consumer (flat
    placement, IVF install, the codes file) must adopt it for queries
    and reconstruction."""
    from clipx_torch.search import pq as pq_lib
    from clipx_torch.search.engine import quantize_rows_rotated

    n, dim = vectors.shape
    out_codes = None
    out_scales = None
    if tier == "pq":
        if codebook is None:
            rot, codebook = pq_lib.train_opq(vectors, rot)
        cdim = codebook.m // 2
        if on_chunk is None:
            out_codes = np.empty((n, cdim), np.int8)
        for i in range(0, n, _PQ_ENC_CHUNK):
            c = codebook.encode(np.asarray(vectors[i: i + _PQ_ENC_CHUNK],
                                           np.float32), rot=rot)
            if on_chunk is None:
                out_codes[i: i + len(c)] = c
            else:
                on_chunk(c, None)
        return {"codes": out_codes, "scales": None,
                "centroids": codebook.centroids, "codebook": codebook,
                "rot_matrix": rot}
    if tier not in ("int8", "int4"):
        raise ValueError(f"unknown tier {tier!r}")
    from clipx_torch.search.engine import coded_center_enabled, corpus_center

    int4 = tier == "int4"
    cdim = dim // 2 if int4 else dim
    if center is None and coded_center_enabled():
        # canonical rotated-space mean (one streaming pre-pass over a
        # possibly-memmapped corpus): codes become residuals, whose
        # finer per-row scale is the centered-storage recall win
        center = corpus_center(vectors, rot)
    if on_chunk is None:
        out_codes = np.empty((n, cdim), np.int8)
        out_scales = np.empty((n,), np.float32)
    for i in range(0, n, _ENC_CHUNK):
        c, s = quantize_rows_rotated(
            np.asarray(vectors[i: i + _ENC_CHUNK], np.float32), rot,
            int4, center=center)
        if on_chunk is None:
            out_codes[i: i + len(c)] = c
            out_scales[i: i + len(s)] = s
        else:
            on_chunk(c, s)
    return {"codes": out_codes, "scales": out_scales,
            "centroids": None, "codebook": None, "rot_matrix": rot,
            "center": center}


def write_payload_file(index_path: str, payload: dict, *, tier: str,
                       content_hash: Optional[bytes] = None,
                       fp_sample: Optional[bytes] = None,
                       verify_sidecar: bool = True) -> None:
    """Write ``<index>.codes`` from an in-RAM encode payload — the IVF
    install path stashes its flat-order encode (including residual
    codes, which depend on the cluster layout and so cannot come from
    ``encode_corpus``) and the CLI persists it here with no re-encode
    and no device round-trip.

    ``fp_sample`` is the sidecar fingerprint the CALLER captured when
    it opened the f32 memmap (TOCTOU guard — computing it here, after
    a minutes-long encode, could stamp old-row codes with a replaced
    sidecar's fingerprint); omitted, it is sampled now for callers
    whose encode was quick. ``verify_sidecar=False`` skips the
    close-time re-check (the sidecar-less direct build)."""
    from clipx_torch.search import engine

    codes = payload["codes"]
    if codes is None:
        raise ValueError("payload carries no codes array")
    n, cdim = codes.shape
    rot = payload.get("rot_matrix")
    residual = bool(payload.get("residual"))
    codebook = payload.get("codebook")
    dim = (codebook.m * codebook.dsub if tier == "pq"
           else cdim * 2 if tier == "int4" else cdim)
    opq = (tier == "pq" and rot is not None
           and not np.array_equal(rot, engine._rotation_matrix(dim)))
    if fp_sample is None:
        fp_sample = sidecar_sample_fp(index_path)
    writer = CodesWriter(
        codes_path(index_path), tier=tier, ntotal=n, dim=dim,
        code_dim=cdim, rotated=rot is not None,
        fp_sample=fp_sample,
        dsub=codebook.dsub if tier == "pq" else None,
        opq=opq, residual=residual,
        layout_digest=payload.get("layout_digest"),
        verify_sidecar=(index_path if verify_sidecar
                        and fp_sample is not None else None),
        center=payload.get("center") if tier in ("int8", "int4")
        else None)
    try:
        step = 1 << 20
        for i in range(0, n, step):
            writer.write_codes(
                codes[i: i + step],
                None if payload["scales"] is None
                else payload["scales"][i: i + step])
        if tier == "pq":
            writer.set_centroids(codebook.centroids)
            if opq:
                writer.set_rotation(rot)
        writer.set_content_hash(content_hash)
        writer.close()
    except BaseException:
        try:
            writer._f.close()
            os.unlink(writer._tmp)
        except OSError:
            pass
        raise


def write_codes_file(index_path: str, vectors, tier: str, *,
                     rot=None, content_hash: Optional[bytes] = None,
                     codebook=None,
                     fp_sample: Optional[bytes] = None) -> None:
    """Encode ``vectors`` (array or sidecar memmap) with the canonical
    encoder and write ``<index>.codes`` atomically. The write streams
    chunk-by-chunk — peak host RAM is one encode chunk plus the scales
    — so callers at capacity scale memmap the sidecar, write the codes
    file, and re-``load_codes`` it (the OS page cache makes the
    read-back cheap) instead of ever holding a full codes copy.

    ``fp_sample``: sidecar fingerprint captured when the caller opened
    the memmap (TOCTOU guard, see write_payload_file); sampled here
    when omitted, and re-checked at close before the atomic rename."""
    from clipx_torch.search import pq as pq_lib

    n, dim = vectors.shape
    if tier == "pq" and codebook is None:
        rot, codebook = pq_lib.train_opq(vectors, rot)
    center = None
    if tier in ("int8", "int4"):
        from clipx_torch.search.engine import coded_center_enabled, corpus_center

        if coded_center_enabled():
            center = corpus_center(vectors, rot)
    cdim = (codebook.m // 2 if tier == "pq"
            else dim // 2 if tier == "int4" else dim)
    if fp_sample is None:
        fp_sample = sidecar_sample_fp(index_path)
    writer = CodesWriter(
        codes_path(index_path), tier=tier, ntotal=n, dim=dim,
        code_dim=cdim, rotated=rot is not None,
        fp_sample=fp_sample,
        dsub=codebook.dsub if tier == "pq" else None,
        opq=tier == "pq" and rot is not None
        and pq_lib.opq_mode() == "trained",
        verify_sidecar=index_path if fp_sample is not None else None,
        center=center)
    try:
        encode_corpus(vectors, tier, rot=rot, codebook=codebook,
                      on_chunk=writer.write_codes, center=center)
        if tier == "pq":
            writer.set_centroids(codebook.centroids)
            if writer.opq:
                writer.set_rotation(rot)
        writer.set_content_hash(content_hash)
        writer.close()
    except BaseException:
        try:
            writer._f.close()
            os.unlink(writer._tmp)
        except OSError:
            pass
        raise
