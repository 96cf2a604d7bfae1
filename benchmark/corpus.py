"""The pq library, the prompts and every other input made from the seed,
and the ``<index>.codes`` file written with the benchmark's own code.

Each input has a generator stream of its own (``stream``), so that making
one does not shift another. The codes file follows ``docs/FORMATS.md``
(the coded-tier sidecar) for a codes-only deployment: tier pq with a
stored rotation (``opq``), no f32 sidecar, and the self-integrity footer.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading

import numpy as np
import torch

STREAM_WEIGHTS, STREAM_FRAMES, STREAM_CODES, STREAM_CENTROIDS, \
    STREAM_ROTATION, STREAM_PROMPTS, STREAM_CLIENTS = range(7)

# the centroids' scale: a row's rotated vector has this std in every dim
CENTROID_STD = 0.05
PQ_K = 16

_MAGIC = b"CLIPXCOD1\n"
_SELF_MAGIC = b"CXSELF1\x00"
_FP_SAMPLE_ROWS = 65536


def stream(seed: int, which: int) -> int:
    """The generator seed of one input stream of a run's seed."""
    return (int(seed) * 16 + which) % (1 << 63)


def generator(seed: int, which: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, which))


def frames(seed: int, n: int, size: int, device) -> torch.Tensor:
    """(n, size, size, 3) uint8 frames on ``device``."""
    return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8,
                         device=device,
                         generator=generator(seed, STREAM_FRAMES, device))


def pq_library(seed: int, rows: int, dim: int, dsub: int, device):
    """(codes (rows, M/2) int8, centroids (M, 16, dsub) f32, rotation
    (dim, dim) f32 orthogonal), all on ``device``; M = dim / dsub. Codes
    are uniform bytes: every centroid equally likely in every subspace."""
    m = dim // dsub
    codes = torch.randint(-128, 128, (rows, m // 2), dtype=torch.int8,
                          device=device,
                          generator=generator(seed, STREAM_CODES, device))
    centroids = torch.randn(
        (m, PQ_K, dsub), device=device,
        generator=generator(seed, STREAM_CENTROIDS, device)) * CENTROID_STD
    g = torch.randn((dim, dim), dtype=torch.float64,
                    generator=generator(seed, STREAM_ROTATION, "cpu"))
    q, r = torch.linalg.qr(g)
    rotation = (q * torch.sign(torch.diagonal(r))).float().to(device)
    return codes, centroids, rotation


def prompts(seed: int, n: int, words, letters) -> list:
    """``n`` prompts of lowercase ASCII words: between ``words[0]`` and
    ``words[1]`` words of ``letters[0]`` to ``letters[1]`` letters."""
    rng = np.random.default_rng(stream(seed, STREAM_PROMPTS))
    out = []
    for _ in range(n):
        nw = int(rng.integers(words[0], words[1] + 1))
        out.append(" ".join(
            "".join(chr(97 + c) for c in rng.integers(
                0, 26, int(rng.integers(letters[0], letters[1] + 1))))
            for _ in range(nw)))
    return out


def write_codes_file(path: str, codes: np.ndarray, centroids: np.ndarray,
                     rotation: np.ndarray, dsub: int) -> int:
    """Write a codes-only pq ``<index>.codes`` file; returns its bytes."""
    ntotal, code_dim = codes.shape
    dim = rotation.shape[0]
    meta = {"version": 1, "tier": "pq", "ntotal": int(ntotal),
            "dim": int(dim), "code_dim": int(code_dim), "rotated": True,
            "self": 1, "dsub": int(dsub), "opq": True}
    blob = json.dumps(meta, sort_keys=True).encode()
    raw = memoryview(np.ascontiguousarray(codes).view(np.uint8).reshape(-1))
    tail = (np.ascontiguousarray(centroids, np.float32).tobytes()
            + np.ascontiguousarray(rotation, np.float32).tobytes())
    full = hashlib.blake2b(blob, digest_size=16)
    # the full hash runs beside the write (both release the GIL)
    hasher = threading.Thread(target=full.update, args=(raw,))
    hasher.start()
    sample = hashlib.blake2b(blob, digest_size=16)
    head = min(ntotal, _FP_SAMPLE_ROWS) * code_dim
    sample.update(raw[:head])
    if ntotal > _FP_SAMPLE_ROWS:
        sample.update(raw[len(raw) - _FP_SAMPLE_ROWS * code_dim:])
    sample.update(tail)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(b"\x00" * 32)  # no sidecar: no fingerprint, no content hash
        f.write(blob)
        step = 1 << 26
        for i in range(0, len(raw), step):
            f.write(raw[i: i + step])
        f.write(tail)
        hasher.join()
        full.update(tail)
        f.write(_SELF_MAGIC + sample.digest() + full.digest())
    return len(_MAGIC) + 4 + 32 + len(blob) + len(raw) + len(tail) + 40
