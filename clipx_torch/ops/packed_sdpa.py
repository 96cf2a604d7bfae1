"""Short-sequence ViT attention: wrappers over the CUDA kernels in csrc/.

Counterpart of ``clipx/ops/packed_sdpa.py`` for the three functions on the
port's path:

- ``fused_attn_block``  — qkv projection -> SDPA -> out projection, the
  whole sublayer between LayerNorm and the residual (``csrc/attn_block.cu``);
- ``packed_sdpa``       — SDPA only, (B, S, H*64) in and out, even heads
  (``csrc/short_sdpa.cu``);
- ``packed_sdpa_rows``  — the same function, any heads, even batch (the
  same CUDA kernel; the TPU's row-pair packing is not carried over).

Every wrapper has a plain PyTorch version beside it (``*_plain``) with the
kernel's rounding points: bf16 inputs are upcast exactly to f32, products
accumulate in f32, and values round to the input dtype where the Pallas
kernels round (qkv, probabilities, per-head outputs, result). A wrapper
runs the plain version only for CPU tensors. For a CUDA tensor it launches
its kernel or raises; any other device raises.

Each wrapper counts its kernel launches in ``LAUNCHES`` (one per call that
launched), so a run can show that its main path went through the kernels.
Constraints as in clipx: S <= 64, D = 64, no causal mask.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

_SP = 64  # padded sequence block
_D = 64
_NEG = -1e30

LAUNCHES: Dict[str, int] = {"fused_attn_block": 0, "packed_sdpa": 0,
                            "packed_sdpa_rows": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _dense_plain(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x @ w + b with f32 accumulation of the (exactly upcast) inputs,
    rounded once to x's dtype."""
    y = torch.matmul(x.float(), w.float()) + b.float()
    return y.to(x.dtype)


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               heads: int) -> torch.Tensor:
    """Non-causal SDPA on (B, S, H*D): f32 scores scaled by 1/sqrt(D),
    f32 max-subtracted softmax, probabilities rounded to the input dtype,
    f32-accumulated probs @ V rounded to the input dtype."""
    b, s, w = q.shape
    d = w // heads

    def split(t):
        return t.reshape(b, s, heads, d).permute(0, 2, 1, 3).float()

    scores = torch.matmul(split(q), split(k).transpose(-1, -2)) * (
        1.0 / (d ** 0.5))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.matmul(probs.float(), split(v)).to(q.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, s, w)


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

_P = ctypes.c_void_p
_I = ctypes.c_int
_fns: Dict[str, object] = {}


def _fn(lib_name: str, sym: str, argtypes):
    fn = _fns.get(sym)
    if fn is None:
        from clipx_torch.ops import _build

        fn = getattr(_build.load(lib_name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[sym] = fn
    return fn


def _check_cuda(name: str, dtype, device, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, the kernel "
                             f"takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def _kernel_device(name: str, x: torch.Tensor) -> torch.device:
    """The device a kernel launches on: a CUDA tensor's. Callers send CPU
    tensors to the plain version first; anything else is refused."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device} "
                         "(CUDA tensors launch the kernel, CPU tensors "
                         "run the plain version)")
    return x.device


def _launch_sdpa(name: str, q, k, v, heads: int) -> torch.Tensor:
    device = _kernel_device(name, q)
    _check_cuda(name, torch.bfloat16, device, q=q, k=k, v=v)
    b, s, w = q.shape
    out = torch.empty_like(q)
    fn = _fn("short_sdpa", "clipx_short_sdpa",
             [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, heads, w, w, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
    return out


def _launch_attn_block(x, wqkv, bqkv, wo, bo, heads: int) -> torch.Tensor:
    name = "fused_attn_block"
    device = _kernel_device(name, x)
    _check_cuda(name, torch.bfloat16, device, x=x, wqkv=wqkv, wo=wo)
    _check_cuda(name, torch.float32, device, bqkv=bqkv, bo=bo)
    b, s, w = x.shape
    qkv_buf = torch.empty((b * s, 3 * w), dtype=x.dtype, device=device)
    attn_buf = torch.empty((b * s, w), dtype=x.dtype, device=device)
    out = torch.empty_like(x)
    fn = _fn("attn_block", "clipx_fused_attn_block",
             [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                wo.data_ptr(), bo.data_ptr(), qkv_buf.data_ptr(),
                attn_buf.data_ptr(), out.data_ptr(), b, s, w, heads, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    LAUNCHES[name] += 1
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
