"""ViT attention and MLP: wrappers over the CUDA kernels in csrc/.

Counterpart of ``clipx/ops/packed_sdpa.py``:

- ``fused_attn_block``    — qkv projection -> SDPA -> out projection, the
  whole sublayer between LayerNorm and the residual, S <= 64
  (``csrc/attn_block.cu``);
- ``fused_attn_sublayer`` — ``x + fused_attn_block(LayerNorm(x))``, the whole
  pre-LN attention sublayer on raw x (the same file);
- ``packed_sdpa``         — SDPA only, (B, S, H*64) in and out, S <= 64,
  even heads (``csrc/sdpa.cu`` on ``csrc/sdpa_sm90.cuh``'s TMA + wgmma
  kernel, which serves every SDPA below);
- ``packed_sdpa_rows``    — the same function, any heads, even batch (the
  same CUDA kernel; the TPU's row-pair packing is not carried over);
- ``packed_sdpa_qkv``     — the same function reading q, k, v out of one
  packed (B, S, 3W) projection, even batch (the same CUDA kernel, bitwise
  equal to ``packed_sdpa``);
- ``fused_sdpa_long``     — SDPA for any S on (B, S, H*D), D in {32, 64,
  72, 128}, optional causal mask (the same kernel; bitwise ``packed_sdpa`` at
  S <= 64, D = 64);
- ``fused_sdpa_long_qkv`` — ``fused_sdpa_long`` on a packed (B, S, 3W)
  projection, then the out projection and its bias (the same file);
- ``fused_mlp``           — the bf16 MLP, x @ W1 + b1 -> activation -> @ W2
  + b2, over any (..., W) (``csrc/mlp.cu``);
- ``fused_mlp_w8a8``      — the W8A8 MLP: per-row int8 activations, int8
  GEMMs, f32 dequantization and activation (the same file).

``mlp_fusible`` and ``mlp_w8a8_fusible`` are clipx's rules for when
``mlp_block`` takes the fused MLPs, copied with their byte arithmetic (a TPU
VMEM budget; kept so both packages take one route per shape).

Every wrapper has a plain PyTorch version beside it (``*_plain``) with the
kernel's rounding points: bf16 inputs are upcast exactly to f32, scores
are scaled by 1/sqrt(D) and masked with -1e30 (keys after the query when
causal), the softmax is f32 and max-subtracted, products accumulate in
f32, and values round to the input dtype where the Pallas kernels round
(qkv, probabilities, per-head outputs, result; the MLPs' hidden layer and
result). A wrapper runs the plain version only for CPU tensors. For a CUDA
tensor it launches its kernel or raises; any other device raises.

Each wrapper counts its kernel launches in ``LAUNCHES`` (one per call that
launched; the dict lives in ``ops/_launch.py`` and also counts the PQ scan
and ``flash_attention``), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import torch

from clipx_torch.models import quant
from clipx_torch.ops._launch import (LAUNCHES, F, I, L, P, c_fn, check_cuda,
                                     kernel_device, launch, launch_counts,
                                     refuse_grad, reset_launches)

__all__ = ["LAUNCHES", "launch_counts", "reset_launches", "fused_attn_block",
           "packed_sdpa", "packed_sdpa_rows", "packed_sdpa_qkv",
           "fused_sdpa_long", "fused_sdpa_long_qkv", "fused_attn_sublayer",
           "fused_mlp", "fused_mlp_w8a8", "mlp_fusible", "mlp_w8a8_fusible",
           "fused_attn_block_plain", "sdpa_plain", "attend_plain",
           "packed_sdpa_qkv_plain", "fused_sdpa_long_plain",
           "fused_sdpa_long_qkv_plain", "fused_attn_sublayer_plain",
           "fused_mlp_plain", "fused_mlp_w8a8_plain"]

_SP = 64  # padded sequence block
_D = 64
_NEG = -1e30
LONG_HEAD_DIMS = (32, 64, 72, 128)  # the SDPA kernel's template instances
_MLP_ROWS = 128  # clipx's token rows a program, read by its VMEM rules
# calls of fused_mlp_w8a8 on CUDA that had to transpose the weights
# themselves (no w1_qt/w2_qt given); the Encoder's route makes none
W8A8_WEIGHT_COPIES = {"calls": 0}
# clipx's budget: both weight matrices in VMEM (~16 MB a core) beside the
# row blocks and the hidden tile
_MLP_VMEM_BUDGET = 12 * 2 ** 20


# the activations the fused MLP kernels' epilogues compute (``quick``)
FUSED_MLP_ACTIVATIONS = ("quick_gelu", "gelu")


def mlp_fusible(width: int, hidden: int, dtype,
                activation: str = "quick_gelu") -> bool:
    """clipx's rule for ``fused_mlp`` (``clipx/ops/packed_sdpa.py:400``):
    at ViT-B/32 it holds in bf16 and not in f32 (18.9 MB of weights), and
    not at ViT-L. Never for an activation the kernel does not compute
    (``gelu_tanh``)."""
    if activation not in FUSED_MLP_ACTIVATIONS:
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    weights = 2 * width * hidden * itemsize
    tiles = (_MLP_ROWS * (2 * width + hidden) * itemsize
             + _MLP_ROWS * hidden * 4)
    return weights + tiles < _MLP_VMEM_BUDGET


def mlp_w8a8_fusible(width: int, hidden: int,
                     activation: str = "quick_gelu") -> bool:
    """clipx's rule for ``fused_mlp_w8a8`` (``:408``): int8 weights, bf16
    x/out tiles, int8 codes, f32 activations and int32 accumulators. Holds
    at ViT-B/32, not at ViT-L; never for ``gelu_tanh``."""
    if activation not in FUSED_MLP_ACTIVATIONS:
        return False
    weights = 2 * width * hidden
    r = _MLP_ROWS
    tiles = (r * width * 2 + r * width + r * hidden * 4 + r * hidden * 4
             + r * hidden + r * width * 4 + r * width * 2)
    return weights + tiles < _MLP_VMEM_BUDGET


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


def fused_attn_sublayer_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                              ln_bias: torch.Tensor, wqkv: torch.Tensor,
                              bqkv: torch.Tensor, wo: torch.Tensor,
                              bo: torch.Tensor, *, heads: int,
                              eps: float = 1e-5) -> torch.Tensor:
    """x + fused_attn_block(LayerNorm(x)): the f32 LayerNorm rounded to x's
    dtype, the block's rounding points, then the residual add rounded once
    (the Pallas kernel's order: the projection rounds before the add)."""
    from clipx_torch.models.layers import layer_norm

    y = layer_norm(x, {"scale": ln_scale, "bias": ln_bias}, eps)
    return x + fused_attn_block_plain(y, wqkv, bqkv, wo, bo, heads=heads)


def _act_f32(h: torch.Tensor, quick: bool) -> torch.Tensor:
    """QuickGELU (x * sigmoid(1.702 x)) or the exact erf GELU, in f32."""
    if quick:
        return h * torch.sigmoid(1.702 * h)
    return torch.nn.functional.gelu(h, approximate="none")


def fused_mlp_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor, *,
                    quick: bool = True) -> torch.Tensor:
    """The Pallas kernel's rounding points: h = x @ w1 + b1 rounded to x's
    dtype, the activation in f32 on it, rounded again, then h @ w2 + b2
    rounded once. (The unfused ``mlp_block`` runs the activation in x's
    dtype instead.)"""
    h = _dense_plain(x, w1.to(x.dtype), b1)
    h = _act_f32(h.float(), quick).to(x.dtype)
    return _dense_plain(h, w2.to(x.dtype), b2)


def fused_mlp_w8a8_plain(x: torch.Tensor, w1_q: torch.Tensor,
                         s1: torch.Tensor, b1: torch.Tensor,
                         w2_q: torch.Tensor, s2: torch.Tensor,
                         b2: torch.Tensor, *,
                         quick: bool = True) -> torch.Tensor:
    """The Pallas kernel's W8A8 MLP: per-row int8 codes of f32(x), an exact
    int8 product dequantized as f32(acc) * (xs * s1) + b1, the activation in
    f32 (no rounding to x's dtype in between, unlike the unfused path), the
    same quantization and product again, rounded once to x's dtype."""
    width = w1_q.shape[0]
    xq, xs = quant.quantize_rows(x.reshape(-1, width).float())
    h = (quant.int_matmul(xq, w1_q).float() * (xs * s1.float())
         + b1.float())
    hq, hs = quant.quantize_rows(_act_f32(h, quick))
    out = (quant.int_matmul(hq, w2_q).float() * (hs * s2.float())
           + b2.float())
    return out.to(x.dtype).reshape(x.shape)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def launch_sdpa(name: str, q: int, k: int, v: int, out: torch.Tensor, *,
                batch: int, heads: int, seq: int, head_dim: int, in_strides,
                out_strides, causal: bool) -> None:
    """The SDPA kernel (``csrc/sdpa.cu``) on bf16 CUDA data: q, k and v are
    the addresses of element (0, 0, 0, 0), and element (b, h, s, d) sits
    at b*sb + h*sh + s*ss + d of each (strides (sb, sh, ss); q, k and v
    share theirs). The kernel reads them through TMA tensor maps, which
    take only 16-byte aligned addresses and strides: anything else raises
    ValueError. Counts the launch under ``name``."""
    for arg, ptr in (("q", q), ("k", k), ("v", v), ("out", out.data_ptr())):
        if ptr % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned; the "
                             "kernel's TMA tensor maps need it")
    if any(st * 2 % 16 for st in in_strides) or any(
            st % 2 for st in out_strides):
        raise ValueError(f"{name}: strides {tuple(in_strides)} (q, k, v) "
                         f"and {tuple(out_strides)} (out) are not 16-byte "
                         "and 4-byte multiples; the kernel's TMA tensor "
                         "maps and bf16 pair stores need them")
    fn = c_fn("sdpa", "clipx_sdpa",
              [P, P, P, P, I, I, I, I, L, L, L, L, L, L, I, P])
    launch(name, fn, out.device, q, k, v, out.data_ptr(), batch, heads, seq,
           head_dim, *in_strides, *out_strides, int(causal))


def _launch_sdpa(name: str, q, k, v, heads: int,
                 causal: bool = False) -> torch.Tensor:
    """B2, B3 and B8: SDPA on (B, S, W) q, k, v."""
    device = kernel_device(name, q, k, v)
    check_cuda(name, torch.bfloat16, device, q=q, k=k, v=v)
    b, s, w = q.shape
    d = w // heads
    out = torch.empty_like(q)
    strides = (s * w, d, w)
    launch_sdpa(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out,
                batch=b, heads=heads, seq=s, head_dim=d, in_strides=strides,
                out_strides=strides, causal=causal)
    return out


def _launch_sdpa_qkv(qkv, heads: int, causal: bool = False) -> torch.Tensor:
    """B4: the same kernel on q, k and v at columns 0, W and 2W of the
    packed (B, S, 3W) projection (any S and D, as B9's attention step)."""
    name = "packed_sdpa_qkv"
    device = kernel_device(name, qkv)
    check_cuda(name, torch.bfloat16, device, qkv=qkv)
    b, s, w3 = qkv.shape
    w = w3 // 3
    d = w // heads
    out = torch.empty((b, s, w), dtype=qkv.dtype, device=device)
    base, step = qkv.data_ptr(), w * qkv.element_size()
    launch_sdpa(name, base, base + step, base + 2 * step, out, batch=b,
                heads=heads, seq=s, head_dim=d, in_strides=(s * w3, d, w3),
                out_strides=(s * w, d, w), causal=causal)
    return out


def _launch_long_qkv(qkv, wo, bo, heads: int, causal: bool,
                     bn: int | None = None) -> torch.Tensor:
    """B9's C call: the SDPA kernel on the packed projection, then the out
    projection on the sm90 GEMM at tile width ``bn`` (default
    ``gemm_tile_n_mn(B*S, W)``)."""
    name = "fused_sdpa_long_qkv"
    device = kernel_device(name, qkv, wo, bo)
    check_cuda(name, torch.bfloat16, device, qkv=qkv, wo=wo)
    check_cuda(name, torch.float32, device, bo=bo)
    b, s, w3 = qkv.shape
    w = w3 // 3
    bn = _tile(name, b * s, w, bn)
    attn_buf = torch.empty((b * s, w), dtype=qkv.dtype, device=device)
    out = torch.empty((b, s, w), dtype=qkv.dtype, device=device)
    fn = c_fn("sdpa", "clipx_fused_sdpa_long_qkv",
              [P, P, P, P, P, I, I, I, I, I, I, P])
    launch(name, fn, device, qkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
           attn_buf.data_ptr(), out.data_ptr(), b, s, w, heads, int(causal),
           bn)
    return out


GEMM_TILES = (192, 128, 64)  # csrc/gemm_sm90.cuh's tile widths, widest first


def gemm_tile_n(n: int) -> int:
    """The out projection's tile width in ``csrc/gemm_sm90.cuh`` (one of
    its template instances: 64, 128 or 192 columns) for N = heads * 64
    output columns: the widest that divides N, so no tile is ragged."""
    for bn in GEMM_TILES:
        if n % bn == 0:
            return bn
    raise ValueError(f"gemm_tile_n: N={n} is not a multiple of 64")


_SMS = 132  # SMs of an H100 SXM (and of an H200)


def gemm_tile_n_mn(m: int, n: int) -> int:
    """The tile width of B7's two GEMMs and B9's out projection for an
    (M, N) output, among the widths that divide N. The GEMM holds one
    128 x width block an SM, so a grid runs in waves of ``_SMS`` blocks.
    Where the widest width leaves the grid short of one wave, the
    narrowest: more blocks put more SMs to work. Otherwise 64 only if
    nothing wider divides N (on wgmma m64n64 it ran B7's down projection
    at 384 TFLOP/s against 513 at 192), and among the others the least
    waves x width,
    ties to the wider (fewer tiles to fill and drain). This reproduces the
    widths measured fastest (``chip_smoke.py`` phase ``kernels``,
    ``tile_widths``): ViT-B/32's image MLP 128 up, 192 down (6,400 rows);
    the text tower's single query 64 (77 rows), its 4,928-row bucket 128;
    ViT-L/14@336px's out projection 128 (73,856 x 1,024)."""
    widths = [bn for bn in GEMM_TILES if n % bn == 0]
    if not widths:
        raise ValueError(f"gemm_tile_n_mn: N={n} is not a multiple of 64")
    rows = -(-m // 128)
    if rows * (n // widths[0]) < _SMS:
        return widths[-1]
    wide = [bn for bn in widths if bn > 64] or widths
    return min(wide, key=lambda bn: -(-rows * (n // bn) // _SMS) * bn)


def _tile(name: str, m: int, n: int, bn: int | None) -> int:
    if bn is None:
        return gemm_tile_n_mn(m, n)
    if bn not in GEMM_TILES or n % bn:
        raise ValueError(f"{name}: tile width {bn} is not one of "
                         f"{GEMM_TILES} dividing N={n}")
    return bn


def _launch_attn_block(x, wqkv, bqkv, wo, bo, heads: int,
                       bn: int | None = None) -> torch.Tensor:
    """B1's C call; the out projection's tile width is ``gemm_tile_n(W)``
    unless ``bn`` names another (for timing)."""
    name = "fused_attn_block"
    device = kernel_device(name, x, wqkv, bqkv, wo, bo)
    check_cuda(name, torch.bfloat16, device, x=x, wqkv=wqkv, wo=wo)
    check_cuda(name, torch.float32, device, bqkv=bqkv, bo=bo)
    b, s, w = x.shape
    bn = gemm_tile_n(w) if bn is None else _tile(name, b * s, w, bn)
    attn_buf = torch.empty((b * s, w), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    fn = c_fn("attn_block", "clipx_fused_attn_block",
              [P, P, P, P, P, P, P, I, I, I, I, I, P])
    launch(name, fn, device, x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
           wo.data_ptr(), bo.data_ptr(), attn_buf.data_ptr(), out.data_ptr(),
           b, s, w, heads, bn)
    return out


def _launch_attn_sublayer(x, ln_scale, ln_bias, wqkv, bqkv, wo, bo,
                          heads: int, eps: float) -> torch.Tensor:
    name = "fused_attn_sublayer"
    device = kernel_device(name, x, ln_scale, ln_bias, wqkv, bqkv, wo, bo)
    check_cuda(name, torch.bfloat16, device, x=x, wqkv=wqkv, wo=wo)
    check_cuda(name, torch.float32, device, ln_scale=ln_scale,
               ln_bias=ln_bias, bqkv=bqkv, bo=bo)
    b, s, w = x.shape
    ln_buf = torch.empty((b * s, w), dtype=x.dtype, device=device)
    attn_buf = torch.empty((b * s, w), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    fn = c_fn("attn_block", "clipx_fused_attn_sublayer",
              [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P])
    launch(name, fn, device, x.data_ptr(), ln_scale.data_ptr(),
           ln_bias.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
           wo.data_ptr(), bo.data_ptr(), ln_buf.data_ptr(),
           attn_buf.data_ptr(), out.data_ptr(), b, s, w, heads,
           gemm_tile_n(w), eps)
    return out


def _launch_mlp(x2, w1, b1, w2, b2, quick: bool,
                tiles: tuple | None = None) -> torch.Tensor:
    """B7's C call: two sm90 GEMMs, (R, W) @ w1 with the activation into a
    bf16 (R, H) scratch, then @ w2. ``tiles`` = (up, down) tile widths,
    default ``gemm_tile_n_mn`` of each (M, N). ``check_cuda`` refuses an
    operand that is not 16-byte aligned, by name: the kernel's TMA tensor
    maps cannot take it."""
    name = "fused_mlp"
    device = kernel_device(name, x2, w1, b1, w2, b2)
    check_cuda(name, torch.bfloat16, device, x=x2, w1=w1, w2=w2)
    check_cuda(name, torch.float32, device, b1=b1, b2=b2)
    rows, width = x2.shape
    hidden = w1.shape[1]
    up, down = tiles or (None, None)
    up, down = _tile(name, rows, hidden, up), _tile(name, rows, width, down)
    h_buf = torch.empty((rows, hidden), dtype=x2.dtype, device=device)
    out = torch.empty_like(x2)
    fn = c_fn("mlp", "clipx_fused_mlp",
              [P, P, P, P, P, P, P, I, I, I, I, I, I, P])
    launch(name, fn, device, x2.data_ptr(), w1.data_ptr(), b1.data_ptr(),
           w2.data_ptr(), b2.data_ptr(), h_buf.data_ptr(), out.data_ptr(),
           rows, width, hidden, int(quick), up, down)
    return out


def launch_mlp_w8a8(x2, w1_qt, s1, b1, w2_qt, s2, b2, *, quick: bool,
                    tiles: tuple | None = None, h: torch.Tensor | None = None):
    """The W8A8 MLP kernel on (R, W) bf16 CUDA rows, with the K-major
    weight codes w1_qt (H, W) and w2_qt (W, H) (``w1_q``, ``w2_q``
    transposed: int8 wgmma reads no other layout). Returns (out, xq, xs),
    the output and the first stage's int8 codes (R, W) and f32 row scales
    (R,), which are bitwise those of ``models.quant.quantize_rows``.
    ``tiles`` = (up, down) tile widths, default ``gemm_tile_n_mn`` of each
    (M, N); ``h``, an (R, H) f32 tensor, receives the hidden layer (else a
    scratch does). Counts the launch under ``fused_mlp_w8a8``."""
    name = "fused_mlp_w8a8"
    device = kernel_device(name, x2, w1_qt, s1, b1, w2_qt, s2, b2)
    check_cuda(name, torch.bfloat16, device, x=x2)
    check_cuda(name, torch.int8, device, w1_qt=w1_qt, w2_qt=w2_qt)
    check_cuda(name, torch.float32, device, s1=s1, b1=b1, s2=s2, b2=b2)
    rows, width = x2.shape
    hidden = w1_qt.shape[0]
    if (tuple(w1_qt.shape) != (hidden, width)
            or tuple(w2_qt.shape) != (width, hidden)):
        raise ValueError(f"{name}: w1_qt {tuple(w1_qt.shape)} and w2_qt "
                         f"{tuple(w2_qt.shape)} are not (H, W) and (W, H) "
                         f"for W={width}")
    up, down = tiles or (None, None)
    up, down = _tile(name, rows, hidden, up), _tile(name, rows, width, down)

    def scratch(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    xq, xs = scratch(rows, width, dtype=torch.int8), scratch(
        rows, dtype=torch.float32)
    if h is None:
        h = scratch(rows, hidden, dtype=torch.float32)
    check_cuda(name, torch.float32, device, h=h)
    if tuple(h.shape) != (rows, hidden):
        raise ValueError(f"{name}: h is {tuple(h.shape)}, expected "
                         f"{(rows, hidden)}")
    hq, hs = scratch(rows, hidden, dtype=torch.int8), scratch(
        rows, dtype=torch.float32)
    out = torch.empty_like(x2)
    fn = c_fn("mlp", "clipx_fused_mlp_w8a8",
              [P] * 13 + [I, I, I, I, I, I, P])
    launch(name, fn, device, x2.data_ptr(), w1_qt.data_ptr(), s1.data_ptr(),
           b1.data_ptr(), w2_qt.data_ptr(), s2.data_ptr(), b2.data_ptr(),
           xq.data_ptr(), xs.data_ptr(), h.data_ptr(), hq.data_ptr(),
           hs.data_ptr(), out.data_ptr(), rows, width, hidden, int(quick),
           up, down)
    return out, xq, xs


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
    refuse_grad("fused_attn_block", x, wqkv, bqkv, wo, bo)
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
    refuse_grad("packed_sdpa", q, k, v)
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
    refuse_grad("packed_sdpa_rows", q, k, v)
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
    refuse_grad("packed_sdpa_qkv", qkv)
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
    optional causal mask. On CUDA D is 32, 64, 72 or 128 and the tensors
    are bf16. Returns (B, S, W)."""
    _check_qkv_shapes("fused_sdpa_long", q, k, v)
    _check_long_width("fused_sdpa_long", q.shape[-1], heads, q.device)
    refuse_grad("fused_sdpa_long", q, k, v)
    if q.device.type == "cpu":
        return fused_sdpa_long_plain(q, k, v, heads=heads, causal=causal)
    return _launch_sdpa("fused_sdpa_long", q, k, v, heads, causal)


def fused_sdpa_long_qkv(qkv: torch.Tensor, wo: torch.Tensor,
                        bo: torch.Tensor, *, heads: int,
                        causal: bool = False) -> torch.Tensor:
    """SDPA + out projection over a packed (B, S, 3W) projection output:
    returns (B, S, W) = attention(q, k, v) @ wo + bo. As clipx's wrapper,
    wo is cast to qkv's dtype and bo to f32. On CUDA W % 64 == 0 (the
    GEMM's tile) and D is 32, 64, 72 or 128."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_sdpa_long_qkv: qkv must be (B, S, 3W), got "
                         f"{tuple(qkv.shape)}")
    w = qkv.shape[-1] // 3
    _check_long_width("fused_sdpa_long_qkv", w, heads, qkv.device)
    if tuple(wo.shape) != (w, w) or bo.numel() != w:
        raise ValueError("fused_sdpa_long_qkv: weight shapes do not match "
                         f"width {w}")
    refuse_grad("fused_sdpa_long_qkv", qkv, wo, bo)
    if qkv.device.type == "cpu":
        return fused_sdpa_long_qkv_plain(qkv, wo, bo, heads=heads,
                                         causal=causal)
    if w % 64:
        raise ValueError(f"fused_sdpa_long_qkv: the kernel needs W % 64 == 0, "
                         f"got W={w}")
    return _launch_long_qkv(qkv, wo.to(qkv.dtype), bo.reshape(w).float(),
                            heads, causal)


def fused_attn_sublayer(x: torch.Tensor, ln_scale: torch.Tensor,
                        ln_bias: torch.Tensor, wqkv: torch.Tensor,
                        bqkv: torch.Tensor, wo: torch.Tensor,
                        bo: torch.Tensor, *, heads: int,
                        eps: float = 1e-5) -> torch.Tensor:
    """``x + attn(LayerNorm(x))`` on raw x (B, S, W): the pre-LN attention
    sublayer, with :func:`fused_attn_block`'s shapes (S <= 64, D = 64) and
    clipx's even-batch rule. As clipx's wrapper: matrices in x's dtype,
    LayerNorm params and biases in f32. On CUDA x is bf16."""
    if x.dim() != 3:
        raise ValueError(f"fused_attn_sublayer: x must be (B, S, W), got "
                         f"{tuple(x.shape)}")
    b, s, w = x.shape
    d = w // heads
    if d != _D or w != heads * d or s > _SP or b % 2:
        raise ValueError(f"fused_attn_sublayer needs D=64, S<=64, even B; "
                         f"got B={b}, W={w}, heads={heads}, S={s}")
    if (tuple(wqkv.shape) != (w, 3 * w) or tuple(wo.shape) != (w, w)
            or bqkv.numel() != 3 * w or bo.numel() != w
            or ln_scale.numel() != w or ln_bias.numel() != w):
        raise ValueError("fused_attn_sublayer: weight shapes do not match "
                         f"width {w}")
    refuse_grad("fused_attn_sublayer", x, ln_scale, ln_bias, wqkv, bqkv, wo,
                bo)
    if x.device.type == "cpu":
        return fused_attn_sublayer_plain(x, ln_scale, ln_bias, wqkv, bqkv, wo,
                                         bo, heads=heads, eps=eps)
    return _launch_attn_sublayer(
        x, ln_scale.reshape(w).float(), ln_bias.reshape(w).float(),
        wqkv.to(x.dtype), bqkv.reshape(3 * w).float(), wo.to(x.dtype),
        bo.reshape(w).float(), heads, eps)


def _check_mlp(name: str, x, w1, w2, b1, b2, device) -> tuple:
    width, hidden = w1.shape
    if (x.shape[-1] != width or tuple(w2.shape) != (hidden, width)
            or b1.numel() != hidden or b2.numel() != width):
        raise ValueError(f"{name}: shapes do not match: x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if device.type != "cpu" and (width % 64 or hidden % 64):
        raise ValueError(f"{name}: the kernel needs W % 64 == 0 and "
                         f"H % 64 == 0, got W={width}, H={hidden}")
    return width, hidden


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, *,
              quick: bool = True) -> torch.Tensor:
    """The transformer MLP over x (..., W): x @ w1 + b1 -> QuickGELU
    (``quick``) or the erf GELU -> @ w2 + b2, w1 (W, H), w2 (H, W). As
    clipx's wrapper: matrices in x's dtype, biases in f32. On CUDA x is
    bf16 and W and H are multiples of 64."""
    width, hidden = _check_mlp("fused_mlp", x, w1, w2, b1, b2, x.device)
    refuse_grad("fused_mlp", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2, quick=quick)
    out = _launch_mlp(x.reshape(-1, width).contiguous(), w1.to(x.dtype),
                      b1.reshape(hidden).float(), w2.to(x.dtype),
                      b2.reshape(width).float(), quick)
    return out.reshape(x.shape)


def fused_mlp_w8a8(x: torch.Tensor, w1_q: torch.Tensor, s1: torch.Tensor,
                   b1: torch.Tensor, w2_q: torch.Tensor, s2: torch.Tensor,
                   b2: torch.Tensor, *, quick: bool = True,
                   w1_qt: torch.Tensor | None = None,
                   w2_qt: torch.Tensor | None = None) -> torch.Tensor:
    """The W8A8 transformer MLP over x (..., W), with int8 weights w1_q (W,
    H), w2_q (H, W) and their per-output-channel f32 scales
    (``models.quant.quantize_weight``'s layout); returns x's dtype. On CUDA
    x is bf16 and W and H are multiples of 64, and the kernel reads the
    K-major copies ``w1_qt`` (H, W) and ``w2_qt`` (W, H) that
    ``models.quant.quantize_mlp_stack`` makes once; without them it makes
    them on every call (counted in ``W8A8_WEIGHT_COPIES``). The plain
    version ignores them."""
    width, hidden = _check_mlp("fused_mlp_w8a8", x, w1_q, w2_q, b1, b2,
                               x.device)
    refuse_grad("fused_mlp_w8a8", x, w1_q, s1, b1, w2_q, s2, b2)
    if x.device.type == "cpu":
        return fused_mlp_w8a8_plain(x, w1_q, s1, b1, w2_q, s2, b2,
                                    quick=quick)
    if w1_qt is None or w2_qt is None:
        W8A8_WEIGHT_COPIES["calls"] += 1
        w1_qt = w1_q.transpose(-1, -2).contiguous()
        w2_qt = w2_q.transpose(-1, -2).contiguous()
    out, _, _ = launch_mlp_w8a8(
        x.reshape(-1, width).contiguous(), w1_qt, s1.reshape(hidden).float(),
        b1.reshape(hidden).float(), w2_qt, s2.reshape(width).float(),
        b2.reshape(width).float(), quick=quick)
    return out.reshape(x.shape)
