"""W8A8 dynamic-quantized matmuls for the image encode (PyTorch).

Counterpart of ``clipx/models/quant.py``, with its operation order kept so
the int8 codes and scales come out bitwise equal:

- weights: symmetric int8, one scale per output channel,
  ``scale = max(amax over the in axis, 1e-12) / 127``,
  ``q = clamp(round(w / scale), -127, 127)`` (``torch.round`` rounds half
  to even, as ``jnp.rint`` does), quantized once when the Encoder is built;
- activations: the same rule per token row, at every call;
- int32 accumulation, dequantized as ``f32(acc) * (x_scale * w_scale)``,
  then ``+ b`` as a separate f32 add, rounded to the caller's dtype.

Opt-in (``CLIPX_COMPUTE=int8`` / ``Encoder(compute_quant="int8")``): the
image tower's MLP, and with ``CLIPX_INT8_ATTN`` / ``CLIPX_INT8_PATCH`` its
attention projections and patch embedding. ``dense_w8a8`` is an XLA product
in clipx, not a Pallas kernel; here it is ``torch._int_mm`` on CUDA and an
int32 ``torch.matmul`` on the CPU (exact: at K = 3,072 the sums reach
127^2 * 3,072 ~ 5e7, past f32's exact 2^24). The fused W8A8 MLP kernel
(``ops.packed_sdpa.fused_mlp_w8a8``) does its own int8 GEMMs.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]

_EPS = 1e-12


def _symmetric_int8(x32: torch.Tensor, dim: int):
    """int8 codes of f32 x with one scale per slice along ``dim`` (kept as
    a size-1 axis). The divisor 127 is a tensor: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal instead, which can
    differ from clipx's (and the kernel's) IEEE division in the last bit."""
    amax = torch.clamp_min(x32.abs().amax(dim=dim, keepdim=True), _EPS)
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 weights. ``w``: (..., in, out),
    any leading stack axes. Returns ``(w_i8, scale)`` with ``scale`` shaped
    (..., out)."""
    q, scale = _symmetric_int8(torch.as_tensor(w).float(), -2)
    return q, scale.squeeze(-2)


def quantize_rows(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic quantization of f32 x (..., K): int8 codes and the
    f32 scales (..., 1)."""
    return _symmetric_int8(x32, -1)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 (M, N) = int8 a (M, K) @ int8 b (K, N). CUDA:
    ``torch._int_mm``, with rows padded past 16 and K and N padded to
    multiples of 8 (zero codes add nothing); CPU: an int32 matmul."""
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(32, -(-m // 8) * 8), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def dense_w8a8(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """``dense`` with both operands int8. x: (..., in) in the compute
    dtype; w_i8: (in, out) int8 with per-output-channel ``w_scale`` (out,).
    Returns x's dtype."""
    x32 = x.float()
    x_i8, x_scale = quantize_rows(x32)
    acc = int_matmul(x_i8.reshape(-1, x.shape[-1]), w_i8)
    acc = acc.reshape(*x.shape[:-1], w_i8.shape[-1])
    y = acc.float() * (x_scale * w_scale.float())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def quantize_patch_embed(pe: Params) -> Params:
    """int8 patch-embedding GEMM (``CLIPX_INT8_PATCH``); a bias (SigLIP's)
    is kept as it is."""
    k_q, s = quantize_weight(pe["kernel"])
    out = {"kernel_q": k_q, "scale": s}
    if "bias" in pe:
        out["bias"] = pe["bias"]
    return out


def quantize_attn_stack(attn: Params) -> Params:
    """int8 q/k/v/out projections (``CLIPX_INT8_ATTN``): ``wq_q``/``sq``/
    ``bq`` and so on, biases unchanged."""
    out = {}
    for name in ("wq", "wk", "wv", "wo"):
        w_q, s = quantize_weight(attn[name])
        out[name + "_q"] = w_q
        out["s" + name[1:]] = s
        out["b" + name[1:]] = attn["b" + name[1:]]
    return out


def quantize_mlp_stack(mlp: Params) -> Params:
    """A (possibly layer-stacked) MLP param group in int8 storage:
    ``w1_q/s1/w2_q/s2`` replace ``w1/w2``, biases unchanged.
    ``layers.mlp_block`` dispatches on the ``w1_q`` key. ``w1_qt`` and
    ``w2_qt`` are the same codes transposed ((..., H, W) and (..., W, H),
    contiguous), made once here for the fused W8A8 MLP's kernel, whose
    int8 GEMM reads only K-major weights; ``w1_q``/``w2_q`` stay for the
    plain and unfused paths."""
    w1_q, s1 = quantize_weight(mlp["w1"])
    w2_q, s2 = quantize_weight(mlp["w2"])
    return {"w1_q": w1_q, "s1": s1, "b1": mlp["b1"],
            "w2_q": w2_q, "s2": s2, "b2": mlp["b2"],
            "w1_qt": w1_q.transpose(-1, -2).contiguous(),
            "w2_qt": w2_q.transpose(-1, -2).contiguous()}
