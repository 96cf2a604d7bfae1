"""ViT attention: wrappers over the CUDA kernels in csrc/.

Counterpart of ``clipx/ops/packed_sdpa.py`` for its attention kernels:

- ``fused_attn_block``    — qkv projection -> SDPA -> out projection, the
  whole sublayer between LayerNorm and the residual, S <= 64
  (``csrc/attn_block.cu``);
- ``packed_sdpa``         — SDPA only, (B, S, H*64) in and out, S <= 64,
  even heads (``csrc/short_sdpa.cu``);
- ``packed_sdpa_rows``    — the same function, any heads, even batch (the
  same CUDA kernel; the TPU's row-pair packing is not carried over);
- ``packed_sdpa_qkv``     — the same function reading q, k, v out of one
  packed (B, S, 3W) projection, even batch (the same CUDA kernel, bitwise
  equal to ``packed_sdpa``);
- ``fused_sdpa_long``     — SDPA for any S on (B, S, H*D), D in {32, 64,
  128}, optional causal mask (``csrc/long_sdpa.cu``);
- ``fused_sdpa_long_qkv`` — ``fused_sdpa_long`` on a packed (B, S, 3W)
  projection, then the out projection and its bias (the same file).

Every wrapper has a plain PyTorch version beside it (``*_plain``) with the
kernel's rounding points: bf16 inputs are upcast exactly to f32, scores
are scaled by 1/sqrt(D) and masked with -1e30 (keys after the query when
causal), the softmax is f32 and max-subtracted, products accumulate in
f32, and values round to the input dtype where the Pallas kernels round
(qkv, probabilities, per-head outputs, result). A wrapper runs the plain
version only for CPU tensors. For a CUDA tensor it launches its kernel or
raises; any other device raises.

Each wrapper counts its kernel launches in ``LAUNCHES`` (one per call that
launched; the dict lives in ``ops/_launch.py`` and also counts the PQ scan
and ``flash_attention``), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import torch

from clipx_torch.ops._launch import (LAUNCHES, I, L, P, c_fn, check_cuda,
                                     kernel_device, launch, reset_launches)

__all__ = ["LAUNCHES", "reset_launches", "fused_attn_block", "packed_sdpa",
           "packed_sdpa_rows", "packed_sdpa_qkv", "fused_sdpa_long",
           "fused_sdpa_long_qkv", "fused_attn_block_plain", "sdpa_plain",
           "attend_plain", "packed_sdpa_qkv_plain", "fused_sdpa_long_plain",
           "fused_sdpa_long_qkv_plain"]

_SP = 64  # padded sequence block
_D = 64
_NEG = -1e30
LONG_HEAD_DIMS = (32, 64, 128)  # the long kernel's template instances


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _dense_plain(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x @ w + b with f32 accumulation of the (exactly upcast) inputs,
    rounded once to x's dtype."""
    y = torch.matmul(x.float(), w.float()) + b.float()
    return y.to(x.dtype)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = False) -> torch.Tensor:
    """SDPA on (B, H, S, D): f32 scores scaled by 1/sqrt(D), keys after the
    query set to -1e30 when causal, f32 max-subtracted softmax normalized
    before its probabilities round to the input dtype, f32-accumulated
    probs @ V rounded to the input dtype."""
    dtype = q.dtype
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        1.0 / (d ** 0.5))
    if causal:
        s = scores.shape[-1]
        later = torch.ones((s, s), dtype=torch.bool,
                           device=scores.device).triu(1)
        scores = scores.masked_fill(later, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(dtype)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               heads: int, causal: bool = False) -> torch.Tensor:
    """SDPA on (B, S, H*D) (``attend_plain`` per head), in that layout."""
    b, s, w = q.shape
    d = w // heads

    def split(t):
        return t.reshape(b, s, heads, d).permute(0, 2, 1, 3)

    out = attend_plain(split(q), split(k), split(v), causal=causal)
    return out.permute(0, 2, 1, 3).reshape(b, s, w)


def _split_qkv(qkv: torch.Tensor):
    """q, k, v of a packed (B, S, 3W) projection, each made contiguous so
    the plain versions see exactly what separate projections give them."""
    w = qkv.shape[-1] // 3
    return [qkv[..., i * w:(i + 1) * w].contiguous() for i in range(3)]


def packed_sdpa_qkv_plain(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    return sdpa_plain(*_split_qkv(qkv), heads=heads)


def fused_sdpa_long_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, heads: int, causal: bool = False) -> torch.Tensor:
    return sdpa_plain(q, k, v, heads=heads, causal=causal)


def fused_sdpa_long_qkv_plain(qkv: torch.Tensor, wo: torch.Tensor,
                              bo: torch.Tensor, *, heads: int,
                              causal: bool = False) -> torch.Tensor:
    """SDPA on the packed projection (head outputs rounded to its dtype),
    then o @ wo summed in f32 over all heads, + bo in f32, rounded once:
    the Pallas kernel's head-by-head f32 sum up to summation order."""
    o = sdpa_plain(*_split_qkv(qkv), heads=heads, causal=causal)
    return _dense_plain(o, wo.to(qkv.dtype), bo)


def fused_attn_block_plain(x: torch.Tensor, wqkv: torch.Tensor,
                           bqkv: torch.Tensor, wo: torch.Tensor,
                           bo: torch.Tensor, *, heads: int) -> torch.Tensor:
    w = x.shape[-1]
    qkv = _dense_plain(x, wqkv.to(x.dtype), bqkv)
    o = sdpa_plain(qkv[..., :w], qkv[..., w:2 * w], qkv[..., 2 * w:],
                   heads=heads)
    return _dense_plain(o, wo.to(x.dtype), bo)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _launch_sdpa(name: str, q, k, v, heads: int) -> torch.Tensor:
    device = kernel_device(name, q)
    check_cuda(name, torch.bfloat16, device, q=q, k=k, v=v)
    b, s, w = q.shape
    out = torch.empty_like(q)
    fn = c_fn("short_sdpa", "clipx_short_sdpa",
              [P, P, P, P, I, I, I, I, I, P])
    launch(name, fn, device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), b, s, heads, w, w)
    return out


def _launch_sdpa_qkv(qkv, heads: int) -> torch.Tensor:
    name = "packed_sdpa_qkv"
    device = kernel_device(name, qkv)
    check_cuda(name, torch.bfloat16, device, qkv=qkv)
    b, s, w3 = qkv.shape
    out = torch.empty((b, s, w3 // 3), dtype=qkv.dtype, device=device)
    fn = c_fn("short_sdpa", "clipx_packed_sdpa_qkv", [P, P, I, I, I, I, P])
    launch(name, fn, device, qkv.data_ptr(), out.data_ptr(), b, s, heads,
           w3 // 3)
    return out


def launch_long_sdpa(name: str, q, k, v, out, *, batch: int, heads: int,
                     seq: int, head_dim: int, in_strides, out_strides,
                     causal: bool) -> None:
    """The long-SDPA kernel on bf16 CUDA tensors whose element (b, h, s, d)
    sits at b*sb + h*sh + s*ss + d of each (strides (sb, sh, ss); q, k and
    v share theirs). Counts the launch under ``name``."""
    fn = c_fn("long_sdpa", "clipx_long_sdpa",
              [P, P, P, P, I, I, I, I, L, L, L, L, L, L, I, P])
    launch(name, fn, out.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), batch, heads, seq, head_dim, *in_strides,
           *out_strides, int(causal))


def _launch_long(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    name = "fused_sdpa_long"
    device = kernel_device(name, q)
    check_cuda(name, torch.bfloat16, device, q=q, k=k, v=v)
    b, s, w = q.shape
    d = w // heads
    out = torch.empty_like(q)
    strides = (s * w, d, w)
    launch_long_sdpa(name, q, k, v, out, batch=b, heads=heads, seq=s,
                     head_dim=d, in_strides=strides, out_strides=strides,
                     causal=causal)
    return out


def _launch_long_qkv(qkv, wo, bo, heads: int, causal: bool) -> torch.Tensor:
    name = "fused_sdpa_long_qkv"
    device = kernel_device(name, qkv)
    check_cuda(name, torch.bfloat16, device, qkv=qkv, wo=wo)
    check_cuda(name, torch.float32, device, bo=bo)
    b, s, w3 = qkv.shape
    w = w3 // 3
    attn_buf = torch.empty((b * s, w), dtype=qkv.dtype, device=device)
    out = torch.empty((b, s, w), dtype=qkv.dtype, device=device)
    fn = c_fn("long_sdpa", "clipx_fused_sdpa_long_qkv",
              [P, P, P, P, P, I, I, I, I, I, P])
    launch(name, fn, device, qkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
           attn_buf.data_ptr(), out.data_ptr(), b, s, w, heads, int(causal))
    return out


def _launch_attn_block(x, wqkv, bqkv, wo, bo, heads: int) -> torch.Tensor:
    name = "fused_attn_block"
    device = kernel_device(name, x)
    check_cuda(name, torch.bfloat16, device, x=x, wqkv=wqkv, wo=wo)
    check_cuda(name, torch.float32, device, bqkv=bqkv, bo=bo)
    b, s, w = x.shape
    qkv_buf = torch.empty((b * s, 3 * w), dtype=x.dtype, device=device)
    attn_buf = torch.empty((b * s, w), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    fn = c_fn("attn_block", "clipx_fused_attn_block",
              [P, P, P, P, P, P, P, P, I, I, I, I, P])
    launch(name, fn, device, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
           wo.data_ptr(), bo.data_ptr(), qkv_buf.data_ptr(),
           attn_buf.data_ptr(), out.data_ptr(), b, s, w, heads)
    return out


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def _check_qkv_shapes(name: str, q, k, v) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, S, W) shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def fused_attn_block(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                     wo: torch.Tensor, bo: torch.Tensor, *,
                     heads: int) -> torch.Tensor:
    """qkv-projection + SDPA + out-projection. x: (B, S, W); wqkv:
    (W, 3W) = [wq | wk | wv]; bqkv: (3W,); wo: (W, W); bo: (W,). S <= 64,
    D = 64. Returns (B, S, W). On CUDA x is bf16; as in clipx's wrapper,
    matrices are cast to x's dtype and biases to f32.

    The TPU kernel's ``rows`` (batch rows packed per 128x128 MXU tile, and
    its B % rows rule) is a TPU tiling choice and has no counterpart."""
    if x.dim() != 3:
        raise ValueError(f"fused_attn_block: x must be (B, S, W), got "
                         f"{tuple(x.shape)}")
    b, s, w = x.shape
    d = w // heads
    if d != _D or w != heads * d or s > _SP:
        raise ValueError(f"fused_attn_block needs D=64, S<=64; got B={b}, "
                         f"W={w}, heads={heads}, S={s}")
    if (tuple(wqkv.shape) != (w, 3 * w) or tuple(wo.shape) != (w, w)
            or bqkv.numel() != 3 * w or bo.numel() != w):
        raise ValueError("fused_attn_block: weight shapes do not match "
                         f"width {w}")
    if x.device.type == "cpu":
        return fused_attn_block_plain(x, wqkv, bqkv, wo, bo, heads=heads)
    # as clipx's wrapper: matrices in x's dtype, biases in f32
    return _launch_attn_block(x, wqkv.to(x.dtype), bqkv.reshape(3 * w).float(),
                              wo.to(x.dtype), bo.reshape(w).float(), heads)


def packed_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                heads: int) -> torch.Tensor:
    """q, k, v: (B, S, W) with W = heads * 64, S <= 64, heads even.
    Returns attention output in the same (B, S, W) layout."""
    _check_qkv_shapes("packed_sdpa", q, k, v)
    b, s, w = q.shape
    d = w // heads
    if d != _D or w != heads * d or heads % 2 or s > _SP:
        raise ValueError(f"packed_sdpa needs D=64, even heads, S<=64; "
                         f"got heads={heads}, D={d}, S={s}")
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v, heads=heads)
    return _launch_sdpa("packed_sdpa", q, k, v, heads)


def packed_sdpa_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     heads: int) -> torch.Tensor:
    """Batch-pair variant of :func:`packed_sdpa`: S <= 64, D = 64, any
    head count, even batch."""
    _check_qkv_shapes("packed_sdpa_rows", q, k, v)
    b, s, w = q.shape
    d = w // heads
    if d != _D or w != heads * d or s > _SP or b % 2:
        raise ValueError(f"packed_sdpa_rows needs D=64, S<=64, even B; "
                         f"got B={b}, D={d}, S={s}")
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v, heads=heads)
    return _launch_sdpa("packed_sdpa_rows", q, k, v, heads)


def packed_sdpa_qkv(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    """SDPA over a packed (B, S, 3W) projection [q | k | v] (one
    ``x @ [wq | wk | wv]``): S <= 64, D = 64, even batch. Returns (B, S,
    W); the same function as :func:`packed_sdpa` on the three slices."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"packed_sdpa_qkv: qkv must be (B, S, 3W), got "
                         f"{tuple(qkv.shape)}")
    b, s, w3 = qkv.shape
    w = w3 // 3
    d = w // heads
    if d != _D or w != heads * d or s > _SP or b % 2:
        raise ValueError(f"packed_sdpa_qkv needs D=64, S<=64, even B; "
                         f"got B={b}, D={d}, S={s}")
    if qkv.device.type == "cpu":
        return packed_sdpa_qkv_plain(qkv, heads=heads)
    return _launch_sdpa_qkv(qkv, heads)


def _check_long_width(name: str, w: int, heads: int, device) -> int:
    d = w // heads
    if heads < 1 or w != heads * d:
        raise ValueError(f"{name}: width {w} is not a multiple of "
                         f"{heads} heads")
    if device.type != "cpu" and d not in LONG_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head dims "
                         f"{LONG_HEAD_DIMS}, got D={d}")
    return d


def fused_sdpa_long(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    heads: int, causal: bool = False) -> torch.Tensor:
    """SDPA for any sequence length on (B, S, W) q, k, v, W = heads * D;
    optional causal mask. On CUDA D is 32, 64 or 128 and the tensors are
    bf16. Returns (B, S, W)."""
    _check_qkv_shapes("fused_sdpa_long", q, k, v)
    _check_long_width("fused_sdpa_long", q.shape[-1], heads, q.device)
    if q.device.type == "cpu":
        return fused_sdpa_long_plain(q, k, v, heads=heads, causal=causal)
    return _launch_long(q, k, v, heads, causal)


def fused_sdpa_long_qkv(qkv: torch.Tensor, wo: torch.Tensor,
                        bo: torch.Tensor, *, heads: int,
                        causal: bool = False) -> torch.Tensor:
    """SDPA + out projection over a packed (B, S, 3W) projection output:
    returns (B, S, W) = attention(q, k, v) @ wo + bo. As clipx's wrapper,
    wo is cast to qkv's dtype and bo to f32. On CUDA W % 64 == 0 (the
    GEMM's tile) and D is 32, 64 or 128."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_sdpa_long_qkv: qkv must be (B, S, 3W), got "
                         f"{tuple(qkv.shape)}")
    w = qkv.shape[-1] // 3
    _check_long_width("fused_sdpa_long_qkv", w, heads, qkv.device)
    if tuple(wo.shape) != (w, w) or bo.numel() != w:
        raise ValueError("fused_sdpa_long_qkv: weight shapes do not match "
                         f"width {w}")
    if qkv.device.type == "cpu":
        return fused_sdpa_long_qkv_plain(qkv, wo, bo, heads=heads,
                                         causal=causal)
    if w % 64:
        raise ValueError(f"fused_sdpa_long_qkv: the kernel needs W % 64 == 0, "
                         f"got W={w}")
    return _launch_long_qkv(qkv, wo.to(qkv.dtype), bo.reshape(w).float(),
                            heads, causal)
