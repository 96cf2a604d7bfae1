"""Multi-head attention for the CLIP towers.

Counterpart of ``clipx/ops/attention.py``. Two implementations behind one
interface, on (B, H, S, D) tensors:

- ``xla``    — ``xla_attention``: plain PyTorch, as the JAX package leaves
               this path to XLA (the causal text tower, and any shape the
               ViT kernels of ``ops/packed_sdpa.py`` do not take);
- ``pallas`` — ``ops.flash_attention.flash_attention``: the hand-written
               long-SDPA CUDA kernel (its plain version for CPU tensors).

``impl="auto"`` picks the kernel for CUDA tensors from S = 256 on
(``_PALLAS_MIN_SEQ``, clipx's threshold), plain attention otherwise.
"""

from __future__ import annotations

import torch

# sequence length from which "auto" takes the fused kernel (clipx's value)
_PALLAS_MIN_SEQ = 256


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


def auto_impl(device: torch.device, seq: int) -> str:
    """What ``impl="auto"`` means for a tensor on ``device`` with ``seq``
    positions."""
    use_kernel = device.type == "cuda" and seq >= _PALLAS_MIN_SEQ
    return "pallas" if use_kernel else "xla"


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        impl: str = "auto") -> torch.Tensor:
    """Batched MHA on (B, H, S, D) tensors."""
    if impl == "auto":
        impl = auto_impl(q.device, q.shape[-2])
    if impl == "pallas":
        from clipx_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    return xla_attention(q, k, v, causal=causal)
