"""The PQ asymmetric-distance scan: a wrapper over ``csrc/pq_scan.cu``.

Counterpart of ``clipx/ops/pq_scan.py::pq_scan_scores``, and like it a
one-hot product: the CUDA kernel builds each 64-row tile's one-hot in
registers and multiplies it by the LUT on the tensor cores (mma.sync, s8 x
s8 -> s32), as the Pallas kernel did on the MXU. For packed codes
(N, M/2) int8 in the split nibble layout (byte j = subspace j low, subspace
j + M/2 high; unsigned nibbles) and an integer-valued LUT (M*16, Q), row
m*16 + c, it returns the (Q, N) f32 scores

    out[q, n] = sum_m lut[m*16 + code(n, m), q]

as exact integer sums (|sum| <= 127*M < 2**24), so the kernel, the plain
version here and clipx's Pallas and XLA paths agree bitwise. The LUT may be
int8 or integer-valued bf16 (values <= 127, converted to int8 exactly).

``pq_scan_scores_plain`` is the plain PyTorch version: unpack, then the
exact integer LUT sums in row chunks, as the one-hot product of
``pq._pq_scan_chunk_xla`` in clipx on CUDA tensors and as ``embedding_bag``
sums on the CPU. The wrapper runs it only for CPU tensors; for a CUDA
tensor it launches the kernel or raises. Launches count in ``LAUNCHES``
(one per call). Q is at most 16, the most queries one search sends.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from clipx_torch.ops._launch import (I, P, c_fn, check_cuda, kernel_device,
                                     launch, refuse_grad)

PQ_K = 16
MAX_Q = 16              # queries per call (the kernel's two n8 blocks)
_PLAIN_CHUNK = 1 << 16  # rows per step of the plain version
_ROW_ALIGN = 8          # code bytes the kernel loads at a time


def unpack_codes4(packed: torch.Tensor) -> torch.Tensor:
    """(..., M/2) packed int8 -> (..., M) uint8 code indices. Logical shifts:
    nibbles are unsigned centroid indices."""
    u = packed.view(torch.uint8)
    return torch.cat([u & 0x0F, u >> 4], dim=-1)


def _check_shapes(packed: torch.Tensor, lut_t: torch.Tensor):
    if packed.dim() != 2 or lut_t.dim() != 2:
        raise ValueError("pq_scan_scores: packed is (N, M/2) and lut_t is "
                         f"(M*16, Q); got {tuple(packed.shape)}, "
                         f"{tuple(lut_t.shape)}")
    n, half = packed.shape
    mk, q = lut_t.shape
    if mk != 2 * half * PQ_K:
        raise ValueError(f"lut rows {mk} != {2 * half * PQ_K}")
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"pq_scan_scores takes 1 to {MAX_Q} queries, "
                         f"got {q}")
    if packed.dtype != torch.int8:
        raise ValueError(f"pq_scan_scores: packed is {packed.dtype}, "
                         "expected torch.int8")
    if lut_t.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"pq_scan_scores: lut_t is {lut_t.dtype}, expected "
                         "int8 or integer-valued bfloat16")
    return n, half, q


def _chunk_scores(codes: torch.Tensor, lut8: torch.Tensor) -> torch.Tensor:
    """Exact (rows, Q) f32 LUT sums of a chunk of (rows, M) unpacked codes.
    On CUDA the one-hot int8 product of ``torch._int_mm`` (int32 sums; it
    wants more than 16 rows and a multiple of 8 columns), as the kernel and
    clipx's XLA path compute it; on the CPU each row's M LUT rows summed by
    ``embedding_bag`` (8x the one-hot product's speed there). Every partial
    sum is an integer below 2**24, so both are exact in any order."""
    rows, m = codes.shape
    q = lut8.shape[1]
    if codes.device.type != "cuda":
        offsets = torch.arange(m, device=codes.device) * PQ_K
        return F.embedding_bag(codes.long() + offsets, lut8.float(),
                               mode="sum")
    iota = torch.arange(PQ_K, dtype=torch.uint8, device=codes.device)
    onehot = (codes[:, :, None] == iota).to(torch.int8).reshape(rows,
                                                                 m * PQ_K)
    rp = max(rows, 32)
    qp = -(-q // 8) * 8
    lhs = onehot
    if rp != rows:
        lhs = torch.zeros((rp, onehot.shape[1]), dtype=torch.int8,
                          device=onehot.device)
        lhs[:rows] = onehot
    rhs = torch.zeros((lut8.shape[0], qp), dtype=torch.int8,
                      device=lut8.device)
    rhs[:, :q] = lut8
    return torch._int_mm(lhs, rhs)[:rows, :q].float()


def pq_scan_scores_plain(packed: torch.Tensor,
                         lut_t: torch.Tensor) -> torch.Tensor:
    """The plain version: unpack, then the exact LUT sums of
    ``_chunk_scores``, ``_PLAIN_CHUNK`` rows at a time. Returns (Q, N)
    f32."""
    n, half, q = _check_shapes(packed, lut_t)
    lut8 = lut_t.to(torch.int8)
    out = torch.empty((q, n), dtype=torch.float32, device=packed.device)
    for i in range(0, n, _PLAIN_CHUNK):
        codes = unpack_codes4(packed[i: i + _PLAIN_CHUNK])     # (c, M)
        out[:, i: i + codes.shape[0]] = _chunk_scores(codes, lut8).T
    return out


def pq_scan_scores(packed: torch.Tensor, lut_t: torch.Tensor) -> torch.Tensor:
    """packed: (N, M/2) int8 split-layout PQ codes; lut_t: (M*16, Q) int8 or
    integer-valued bf16 LUT (``pq.quantized_luts``' luti, transposed).
    Returns (Q, N) f32 raw LUT-sum scores (no per-query scale: callers rank
    per query, where a positive scale changes nothing).

    The Pallas kernel's ``permute_lut`` and its row-tile rule are Mosaic
    layout choices and have no counterpart: any N is taken."""
    name = "pq_scan_scores"
    n, half, q = _check_shapes(packed, lut_t)
    refuse_grad(name, packed, lut_t)
    if packed.device.type == "cpu":
        return pq_scan_scores_plain(packed, lut_t)
    device = kernel_device(name, packed, lut_t)
    lut8 = lut_t.to(torch.int8).contiguous()
    # the kernel reads code rows 8 bytes at a time: a half that is not a
    # multiple of 8 is padded with zero bytes, whose LUT rows it zeroes
    pitch = -(-half // _ROW_ALIGN) * _ROW_ALIGN
    if pitch != half:
        packed = torch.nn.functional.pad(packed, (0, pitch - half))
    check_cuda(name, torch.int8, device, packed=packed, lut_t=lut8)
    out = torch.empty((q, n), dtype=torch.float32, device=device)
    if n == 0:
        return out
    fn = c_fn("pq_scan", "clipx_pq_scan", [P, P, P, I, I, I, I, P])
    launch(name, fn, device, packed.data_ptr(), lut8.data_ptr(),
           out.data_ptr(), n, half, pitch, q)
    return out
