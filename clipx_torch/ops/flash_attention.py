"""Fused attention on (B, H, S, D): the wrapper over the SDPA CUDA kernel
in ``csrc/sdpa.cu`` (``csrc/sdpa_sm90.cuh``).

Counterpart of ``clipx/ops/flash_attention.py::flash_attention``, reached
through ``attn_impl="pallas"`` (every tower, the causal text tower
included) and ``ops.attention.multihead_attention``. The Pallas kernel pads
D to 128 for the TPU's lanes; the CUDA kernel keeps the real D (32, 64, 72
or 128) and reads the (B, H, S, D) layout through the strides of its tensor
maps, the same kernel that ``fused_sdpa_long`` runs on (B, S, H*D).

``flash_attention_plain`` has the kernel's rounding points (``attend_plain``
in ``ops/packed_sdpa.py``). The wrapper runs it only for CPU tensors; for a
CUDA tensor it launches the kernel (bf16) or raises, and counts the launch
in ``LAUNCHES["flash_attention"]``.
"""

from __future__ import annotations

import torch

from clipx_torch.ops._launch import check_cuda, kernel_device, refuse_grad
from clipx_torch.ops.packed_sdpa import (LONG_HEAD_DIMS, attend_plain,
                                         launch_sdpa)

__all__ = ["flash_attention", "flash_attention_plain"]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False) -> torch.Tensor:
    return attend_plain(q, k, v, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False) -> torch.Tensor:
    """SDPA on (B, H, S, D) q, k, v; returns (B, H, S, D) in q's dtype.
    On CUDA the tensors are bf16 and D is 32, 64, 72 or 128."""
    name = "flash_attention"
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one (B, H, S, D) "
                         f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    d = q.shape[-1]
    refuse_grad(name, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if d not in LONG_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head dims "
                         f"{LONG_HEAD_DIMS}, got D={d}")
    return _launch(q, k, v, causal)


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """B10's C call: the SDPA kernel with (B, H, S, D) strides."""
    name = "flash_attention"
    device = kernel_device(name, q, k, v)
    check_cuda(name, torch.bfloat16, device, q=q, k=k, v=v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    strides = (h * s * d, s * d, d)
    launch_sdpa(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), out,
                batch=b, heads=h, seq=s, head_dim=d, in_strides=strides,
                out_strides=strides, causal=causal)
    return out
