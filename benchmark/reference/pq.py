"""Product-quantisation scoring, plain PyTorch: asymmetric distances from
the centroids and codes the benchmark made, then an exact top-k.

A row's M 4-bit codes are packed two a byte in the split layout of
``docs/FORMATS.md`` (byte j: code j in the low nibble, code j + M/2 in the
high one). Its vector, in the rotated space the codes live in, is the
concatenation of centroid ``code(m)`` of each subspace m; a query's score
is its rotated vector (query @ rotation) dotted with that. Every row is
decoded and scored in f32 with TF32 off; ``dtype=torch.bfloat16`` decodes
and scores in bf16 instead (f32 accumulation), for the control.
"""

from __future__ import annotations

import torch

from benchmark.reference.clip import no_tf32


def decode(codes: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(n, M/2) int8 packed codes -> (n, M * dsub) f32 rotated rows."""
    m, k, dsub = centroids.shape
    u = codes.view(torch.uint8).long()
    idx = torch.cat([u & 0x0F, u >> 4], dim=1)              # (n, M)
    flat = idx + torch.arange(m, device=codes.device) * k
    return centroids.reshape(m * k, dsub)[flat].reshape(codes.shape[0],
                                                        m * dsub)


def rotate(queries: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    with no_tf32():
        return queries.float() @ rotation


def top_k(codes: torch.Tensor, centroids: torch.Tensor,
          queries_rot: torch.Tensor, k: int, *, block: int = 1 << 18,
          dtype=torch.float32):
    """Exact top-k (scores descending, row ids) of every row for each
    rotated query: (Q, k) f32, (Q, k) int64."""
    best_d = best_i = None
    q = queries_rot.to(dtype)
    with no_tf32():
        for start in range(0, codes.shape[0], block):
            rows = decode(codes[start: start + block], centroids).to(dtype)
            s = (q @ rows.T).float()
            d, i = torch.topk(s, min(k, s.shape[1]), dim=1)
            i = i + start
            if best_d is not None:
                d, j = torch.topk(torch.cat([best_d, d], 1), k, dim=1)
                i = torch.gather(torch.cat([best_i, i], 1), 1, j)
            best_d, best_i = d, i
    return best_d, best_i


def row_scores(codes: torch.Tensor, centroids: torch.Tensor,
               queries_rot: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(Q, k) f32 scores of the given rows for each rotated query."""
    q, k = ids.shape
    with no_tf32():
        rows = decode(codes[ids.reshape(-1)], centroids).reshape(q, k, -1)
        return torch.einsum("qd,qkd->qk", queries_rot.float(), rows)
