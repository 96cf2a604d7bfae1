"""Plain multi-head attention for the shapes the kernels do not take.

Counterpart of ``clipx.ops.attention.xla_attention``: the causal text tower
(S = 77) and any (S, D) outside the short-SDPA kernels' S <= 64, D = 64.
Plain PyTorch, as the JAX package leaves this path to XLA.
"""

from __future__ import annotations

import torch


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *, causal: bool = False) -> torch.Tensor:
    """q, k, v: (B, H, S, D). Returns (B, H, S, D) in q's dtype.

    Scores are accumulated and softmaxed in float32 whatever the input
    dtype (bf16 inputs upcast exactly, so this is an f32-accumulated
    product of the bf16 values), the probabilities are rounded to the
    input dtype, and probs @ V accumulates in f32 before rounding back."""
    dtype = q.dtype
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / (d ** 0.5))
    if causal:
        s = scores.shape[-1]
        mask = torch.ones((s, s), dtype=torch.bool,
                          device=scores.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs.float(), v.float()).to(dtype)
