"""Transformer building blocks for the CLIP towers (PyTorch).

Counterpart of ``clipx/models/layers.py``. Plain functions on tensors:
every layer is ``f(x, params) -> x`` over the same nested param dicts that
``clipx.models.convert`` produces (converted to tensors by
``clipx_torch.models.convert.from_jax_params``). Per-tower blocks are
stacked along a leading layer axis; ``transformer`` is a Python loop over
it (PyTorch runs eagerly, so there is nothing to gain from a scan).

Numerical policy, as in clipx: matmuls run in the activations' dtype
(bf16 on the GPU, f32 on the CPU) with f32 accumulation; LayerNorm
statistics and softmax are f32. On the GPU a bf16 ``dense`` rounds its
product once in cuBLAS with the bias rounded to bf16 (clipx adds the f32
bias before its one rounding): a bf16-level difference, inside the stated
tolerances. In f32 the two agree.

Not carried over from clipx: the W8A8 branches, ``CLIPX_FUSED_MLP``, the
``CLIPX_PACKED_SDPA`` variants other than the default, ``CLIPX_ATTN_ROWS``
(a TPU tiling knob that does not change results), and ``remat``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from clipx_torch.ops.attention import xla_attention

Params = Dict[str, Any]


def layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    # OpenAI CLIP's activation: x * sigmoid(1.702 x)
    return x * torch.sigmoid(1.702 * x)


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    w = w.to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if b is None:
        y = torch.matmul(x2, w)
    else:
        y = torch.addmm(b.to(x.dtype), x2, w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def fused_qkv(p: Params):
    """[wq | wk | wv] and the matching bias, packed along the out dim (the
    layout fused_attn_block consumes). The Encoder stores them once as
    ``wqkv``/``bqkv``; otherwise they are concatenated here."""
    if "wqkv" in p:
        return p["wqkv"], p["bqkv"]
    return (torch.cat([p["wq"], p["wk"], p["wv"]], dim=-1),
            torch.cat([p["bq"], p["bk"], p["bv"]], dim=-1))


def mha_block(x: torch.Tensor, p: Params, heads: int, *,
              causal: bool) -> torch.Tensor:
    """Self-attention. x: (B, S, W).

    Dispatch for S <= 64, D = 64, non-causal (the ViT towers):
    - even batch, even heads -> ``fused_attn_block`` (the whole sublayer);
    - odd batch, even heads  -> ``packed_sdpa`` between plain projections;
    - even batch, odd heads  -> ``packed_sdpa_rows`` between them.
    Everything else (the causal text tower, long sequences, odd batch with
    odd heads) takes plain attention. CUDA tensors launch the CUDA kernels;
    CPU tensors reach each kernel's plain version through the same calls.
    (clipx sends the even-batch odd-heads case to fused_attn_block too;
    both compute the same function.)"""
    from clipx_torch.ops import packed_sdpa as ps

    b, s, w = x.shape
    d = w // heads
    short = not causal and s <= 64 and d == 64
    if short and b % 2 == 0 and heads % 2 == 0:
        wqkv, bqkv = fused_qkv(p)
        return ps.fused_attn_block(x, wqkv, bqkv, p["wo"], p["bo"],
                                   heads=heads)
    q = dense(x, p["wq"], p["bq"])
    k = dense(x, p["wk"], p["bk"])
    v = dense(x, p["wv"], p["bv"])
    if short and heads % 2 == 0:
        o = ps.packed_sdpa(q, k, v, heads=heads)
    elif short and b % 2 == 0:
        o = ps.packed_sdpa_rows(q, k, v, heads=heads)
    else:
        def split(t):
            return t.reshape(b, s, heads, d).permute(0, 2, 1, 3)

        o = xla_attention(split(q), split(k), split(v), causal=causal)
        o = o.permute(0, 2, 1, 3).reshape(b, s, w)
    return dense(o, p["wo"], p["bo"])


def mlp_block(x: torch.Tensor, p: Params, use_quick_gelu: bool) -> torch.Tensor:
    h = dense(x, p["w1"], p["b1"])
    h = (quick_gelu(h) if use_quick_gelu
         else torch.nn.functional.gelu(h, approximate="none"))
    return dense(h, p["w2"], p["b2"])


def residual_block(x: torch.Tensor, p: Params, heads: int, *, causal: bool,
                   eps: float, use_quick_gelu: bool) -> torch.Tensor:
    """Pre-LN transformer block (the CLIP/GPT-2 layout)."""
    x = x + mha_block(layer_norm(x, p["ln_1"], eps), p["attn"], heads,
                      causal=causal)
    x = x + mlp_block(layer_norm(x, p["ln_2"], eps), p["mlp"], use_quick_gelu)
    return x


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer i of a stacked block tree (views, no copies)."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def transformer(x: torch.Tensor, stacked: Params, heads: int, *,
                causal: bool, eps: float,
                use_quick_gelu: bool) -> torch.Tensor:
    """Run the stacked blocks in order over the leading layer axis."""
    layers = next(iter(stacked["ln_1"].values())).shape[0]
    for i in range(layers):
        x = residual_block(x, layer_slice(stacked, i), heads, causal=causal,
                           eps=eps, use_quick_gelu=use_quick_gelu)
    return x
