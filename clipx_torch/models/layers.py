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

Attention takes clipx's dispatch (``mha_block``): the same size rules,
the ``CLIPX_PACKED_SDPA`` variants (``sublayer`` included, which
``residual_block`` sends through ``fused_attn_sublayer``) and ``attn_impl``,
so both packages run the same kernel for every shape. The MLP takes
clipx's too (``mlp_block``): ``CLIPX_FUSED_MLP=on`` sends it through
``fused_mlp`` where ``mlp_fusible`` allows it (ViT-B/32 in bf16, not in
f32), and params quantized by ``models.quant`` (``w1_q``, ``wq_q``) run
W8A8, through ``fused_mlp_w8a8`` under ``CLIPX_FUSED_MLP_INT8=on``. clipx
takes the kernels only on a TPU; the port takes them on every device (CUDA
tensors launch them, CPU tensors reach their plain versions).

The activation is a name from ``ACTIVATIONS`` (``CLIPConfig.activation``):
``quick_gelu``, the exact ``gelu``, or SigLIP's ``gelu_tanh``, which the
fused MLP kernels' epilogues do not compute, so its MLP always takes the
unfused route. ``map_head`` is SigLIP's
attention-pooling head.

``remat`` (training) recomputes each residual block in the backward pass,
as clipx's ``jax.checkpoint`` of the scan body does. Not carried over from
clipx: ``CLIPX_ATTN_ROWS`` (a TPU tiling knob that does not change
results).
"""

from __future__ import annotations

import os
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


ACTIVATIONS = ("quick_gelu", "gelu", "gelu_tanh")


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
    layout fused_attn_block, packed_sdpa_qkv and fused_sdpa_long_qkv
    consume). The Encoder stores them once as ``wqkv``/``bqkv``; otherwise
    they are concatenated here."""
    if "wqkv" in p:
        return p["wqkv"], p["bqkv"]
    return (torch.cat([p["wq"], p["wk"], p["wv"]], dim=-1),
            torch.cat([p["bq"], p["bk"], p["bv"]], dim=-1))


SDPA_VARIANTS = ("auto", "block", "sublayer", "pairs", "rows", "qkv")
ATTN_IMPLS = ("xla", "pallas", "plain")


def sdpa_variant() -> str:
    """CLIPX_PACKED_SDPA normalized as clipx does: unknown values mean
    'auto' rather than silently selecting an arbitrary kernel."""
    v = os.environ.get("CLIPX_PACKED_SDPA", "auto")
    return v if v in SDPA_VARIANTS else "auto"


def routes() -> tuple:
    """The environment's routing settings the dispatch below reads
    (``CLIPX_PACKED_SDPA``, ``CLIPX_FUSED_MLP``, ``CLIPX_FUSED_MLP_INT8``):
    a CUDA graph holds the route they chose when it was captured."""
    return (sdpa_variant(), os.environ.get("CLIPX_FUSED_MLP", "off"),
            os.environ.get("CLIPX_FUSED_MLP_INT8", "off"))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def mha_block(x: torch.Tensor, p: Params, heads: int, *, causal: bool,
              attn_impl: str = "xla") -> torch.Tensor:
    """Self-attention. x: (B, S, W).

    clipx's dispatch (``clipx/models/layers.py:104-194``), with its
    size rules kept as they are (they were set by the TPU's VMEM, but keep
    both packages on one route per shape). For the non-causal towers under
    ``attn_impl="xla"``:

    - S <= 64, D = 64 (even heads or even batch), even batch:
      ``fused_attn_block`` (variants auto, block) or ``packed_sdpa_qkv``
      between plain projections (qkv);
    - otherwise in that range: ``packed_sdpa_rows`` (variant rows, or odd
      heads) or ``packed_sdpa``;
    - S > 64 with K/V under clipx's 8 MiB: ``fused_sdpa_long``, or under
      ``=qkv`` (and clipx's 12 MiB rule) ``fused_sdpa_long_qkv``.

    ``attn_impl="pallas"`` sends every tower, causal included, through
    ``flash_attention``; ``"plain"`` and everything else take plain
    attention. CUDA tensors launch the CUDA kernels; CPU tensors reach
    each kernel's plain version through the same calls."""
    from clipx_torch.ops import packed_sdpa as ps

    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r} "
                         f"(one of {ATTN_IMPLS})")
    b, s, w = x.shape
    d = w // heads

    def split(t):
        return t.reshape(b, s, heads, d).permute(0, 2, 1, 3)

    if "wq_q" in p:
        # W8A8 projections (CLIPX_INT8_ATTN) around the SDPA-only kernels
        from clipx_torch.models import quant

        q = quant.dense_w8a8(x, p["wq_q"], p["sq"], p["bq"])
        k = quant.dense_w8a8(x, p["wk_q"], p["sk"], p["bk"])
        v = quant.dense_w8a8(x, p["wv_q"], p["sv"], p["bv"])
        fits = s <= 64 and d == 64 and not causal
        if fits and b % 2 == 0:
            o = ps.packed_sdpa_rows(q, k, v, heads=heads)
        elif fits and heads % 2 == 0:
            o = ps.packed_sdpa(q, k, v, heads=heads)
        else:
            o = xla_attention(split(q), split(k), split(v), causal=causal)
            o = o.permute(0, 2, 1, 3).reshape(b, s, w)
        return quant.dense_w8a8(o, p["wo_q"], p["so"], p["bo"])

    use_packed = s <= 64 and d == 64 and (heads % 2 == 0 or b % 2 == 0)
    use_long = s > 64 and _round_up(s, 128) * w * 2 * 2 < 8 * 2 ** 20
    if not causal and (use_packed or use_long) and attn_impl == "xla":
        variant = sdpa_variant()
        if use_packed and b % 2 == 0 and variant in ("auto", "block"):
            wqkv, bqkv = fused_qkv(p)
            return ps.fused_attn_block(x, wqkv, bqkv, p["wo"], p["bo"],
                                       heads=heads)
        if use_packed and b % 2 == 0 and variant == "qkv":
            wqkv, bqkv = fused_qkv(p)
            o = ps.packed_sdpa_qkv(dense(x, wqkv, bqkv), heads=heads)
            return dense(o, p["wo"], p["bo"])
        if not use_packed:
            s_pad = _round_up(s, 128)
            fits = (2 * s_pad * 3 * w * 2 + w * w * 2) < 12 * 2 ** 20
            if fits and variant == "qkv":
                wqkv, bqkv = fused_qkv(p)
                return ps.fused_sdpa_long_qkv(dense(x, wqkv, bqkv), p["wo"],
                                              p["bo"], heads=heads)
        q = dense(x, p["wq"], p["bq"])
        k = dense(x, p["wk"], p["bk"])
        v = dense(x, p["wv"], p["bv"])
        if not use_packed:
            o = ps.fused_sdpa_long(q, k, v, heads=heads)
        elif b % 2 == 0 and (variant == "rows" or heads % 2):
            o = ps.packed_sdpa_rows(q, k, v, heads=heads)
        else:
            o = ps.packed_sdpa(q, k, v, heads=heads)
        return dense(o, p["wo"], p["bo"])

    q = split(dense(x, p["wq"], p["bq"]))
    k = split(dense(x, p["wk"], p["bk"]))
    v = split(dense(x, p["wv"], p["bv"]))
    if attn_impl == "pallas":
        from clipx_torch.ops.flash_attention import flash_attention

        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal)
    else:
        o = xla_attention(q, k, v, causal=causal)
    o = o.permute(0, 2, 1, 3).reshape(b, s, w)
    return dense(o, p["wo"], p["bo"])


def _activation(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "quick_gelu":
        return quick_gelu(h)
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r} (one of "
                         f"{ACTIVATIONS})")
    return torch.nn.functional.gelu(
        h, approximate="tanh" if activation == "gelu_tanh" else "none")


def mlp_block(x: torch.Tensor, p: Params, activation: str) -> torch.Tensor:
    """The MLP, clipx's dispatch (``clipx/models/layers.py:197-238``):
    W8A8 when the params are quantized (``w1_q``), through
    ``fused_mlp_w8a8`` under ``CLIPX_FUSED_MLP_INT8=on`` where
    ``mlp_w8a8_fusible`` allows it (with the K-major weight copies
    ``quantize_mlp_stack`` made); otherwise ``fused_mlp`` under
    ``CLIPX_FUSED_MLP=on`` where ``mlp_fusible`` allows it for x's dtype;
    else dense -> activation (in x's dtype) -> dense. The fusible rules
    refuse an activation the kernels' epilogues do not compute
    (``gelu_tanh``)."""
    from clipx_torch.ops import packed_sdpa as ps

    quick = activation == "quick_gelu"
    if "w1_q" in p:
        from clipx_torch.models import quant

        w, hidden = p["w1_q"].shape
        if (os.environ.get("CLIPX_FUSED_MLP_INT8", "off") == "on"
                and ps.mlp_w8a8_fusible(w, hidden, activation)):
            return ps.fused_mlp_w8a8(x, p["w1_q"], p["s1"], p["b1"],
                                     p["w2_q"], p["s2"], p["b2"],
                                     quick=quick,
                                     w1_qt=p.get("w1_qt"),
                                     w2_qt=p.get("w2_qt"))
        h = _activation(quant.dense_w8a8(x, p["w1_q"], p["s1"], p["b1"]),
                        activation)
        return quant.dense_w8a8(h, p["w2_q"], p["s2"], p["b2"])
    w, hidden = p["w1"].shape
    if (os.environ.get("CLIPX_FUSED_MLP", "off") == "on"
            and ps.mlp_fusible(w, hidden, x.dtype, activation)):
        return ps.fused_mlp(x, p["w1"], p["b1"], p["w2"], p["b2"],
                            quick=quick)
    h = _activation(dense(x, p["w1"], p["b1"]), activation)
    return dense(h, p["w2"], p["b2"])


def map_head(x: torch.Tensor, p: Params, heads: int, *, eps: float,
             activation: str) -> torch.Tensor:
    """SigLIP's multihead attention-pooling head (big_vision's
    ``MAPHead``, Hugging Face's ``SiglipMultiheadAttentionPoolingHead``):
    one learned probe attends over every token of x (B, S, W), then
    ``h + mlp(LN(h))``; returns (B, W). The probe's q projection is made
    once for the batch; k and v are projected over all S tokens. The
    attention is plain (Q = 1: B x heads x 1 x S scores), not a kernel of
    ``ops``, which take self-attention."""
    b, s, w = x.shape
    d = w // heads
    a = p["attn"]
    probe = p["probe"].reshape(1, 1, w).to(x.dtype)
    q = dense(probe, a["wq"], a["bq"]).reshape(1, heads, 1, d)
    k = dense(x, a["wk"], a["bk"]).reshape(b, s, heads, d).permute(0, 2, 1, 3)
    v = dense(x, a["wv"], a["bv"]).reshape(b, s, heads, d).permute(0, 2, 1, 3)
    o = xla_attention(q.expand(b, heads, 1, d), k, v, causal=False)
    h = dense(o.reshape(b, 1, w), a["wo"], a["bo"])
    h = h + mlp_block(layer_norm(h, p["ln"], eps), p["mlp"], activation)
    return h[:, 0]


def residual_block(x: torch.Tensor, p: Params, heads: int, *, causal: bool,
                   eps: float, activation: str,
                   attn_impl: str = "xla") -> torch.Tensor:
    """Pre-LN transformer block (the CLIP/GPT-2 layout). Under
    ``CLIPX_PACKED_SDPA=sublayer`` an even-batch, S <= 64, D = 64 block
    without quantized attention runs its attention sublayer (LayerNorm,
    attention, residual add) as one ``fused_attn_sublayer``, as clipx's
    ``residual_block`` does (``clipx/models/layers.py:247-261``)."""
    b, s, w = x.shape
    if (not causal and s <= 64 and w // heads == 64 and b % 2 == 0
            and attn_impl == "xla" and "wq_q" not in p["attn"]
            and sdpa_variant() == "sublayer"):
        from clipx_torch.ops import packed_sdpa as ps

        a = p["attn"]
        wqkv, bqkv = fused_qkv(a)
        x = ps.fused_attn_sublayer(x, p["ln_1"]["scale"], p["ln_1"]["bias"],
                                   wqkv, bqkv, a["wo"], a["bo"], heads=heads,
                                   eps=eps)
    else:
        x = x + mha_block(layer_norm(x, p["ln_1"], eps), p["attn"], heads,
                          causal=causal, attn_impl=attn_impl)
    x = x + mlp_block(layer_norm(x, p["ln_2"], eps), p["mlp"], activation)
    return x


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer i of a stacked block tree (views, no copies)."""
    return {k: (layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def transformer(x: torch.Tensor, stacked: Params, heads: int, *,
                causal: bool, eps: float, activation: str,
                attn_impl: str = "xla", remat: bool = False) -> torch.Tensor:
    """Run the stacked blocks in order over the leading layer axis. With
    ``remat`` (and grad mode on) each block keeps only its input for the
    backward pass and runs again there (``torch.utils.checkpoint``,
    non-reentrant): clipx's ``jax.checkpoint`` of the block body
    (``clipx/models/layers.py:272-291``), activation memory for FLOPs."""
    layers = next(iter(stacked["ln_1"].values())).shape[0]
    remat = remat and torch.is_grad_enabled()
    for i in range(layers):
        p = layer_slice(stacked, i)
        if remat:
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(residual_block, x, p, heads, causal=causal,
                           eps=eps, activation=activation,
                           attn_impl=attn_impl, use_reentrant=False)
        else:
            x = residual_block(x, p, heads, causal=causal, eps=eps,
                               activation=activation,
                               attn_impl=attn_impl)
    return x
