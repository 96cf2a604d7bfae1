"""The yardstick's arithmetic: the card's peaks, the towers' model FLOPs and
each measured kernel's operations and bytes, all from shapes alone.

Peaks are NVIDIA's published dense rates of one H100 SXM at its full 700 W
limit. A roofline share is the least time the card could take for a call,
the larger of operations over the peak rate and bytes over the peak
bandwidth, divided by the call's device time. Each input byte is counted
once and each output byte once, whatever a kernel reads again.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

BF16 = 2
F32 = 4


def bound_s(ops: float, nbytes: float, peak_ops: float = PEAK_BF16_FLOPS):
    """(seconds, what bounds it): the least time of a call at the peaks."""
    t_ops, t_bytes = ops / peak_ops, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_flops(b: int, h: int, s: int, d: int, causal: bool = False) -> int:
    """QK^T and P @ V over the (query, key) pairs the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * h * pairs * d


def block_flops(s: int, w: int, heads: int, causal: bool = False) -> int:
    """One pre-LN residual block a sequence: the q, k, v and out
    projections, attention, and the 4x MLP (matmuls only)."""
    proj = 2 * s * w * 4 * w
    mlp = 2 * s * w * 4 * w * 2
    return proj + mlp + attn_flops(1, heads, s, w // heads, causal)


def image_tower_flops(vision: dict) -> int:
    """Model FLOPs of one image through the ViT tower: patch embedding,
    the blocks and the projection."""
    p, size, w = vision["patch_size"], vision["image_size"], vision["width"]
    patches = (size // p) ** 2
    s = patches + 1
    return (2 * patches * p * p * 3 * w
            + vision["layers"] * block_flops(s, w, vision["heads"])
            + 2 * w * vision["embed_dim"])


def text_tower_flops(text: dict) -> int:
    """Model FLOPs of one text through the causal tower: every one of the
    context's positions runs (the tower pads to it), the projection only
    at the end-of-text position."""
    s, w = text["context_length"], text["width"]
    return (text["layers"] * block_flops(s, w, text["heads"], causal=True)
            + 2 * w * text["embed_dim"])


def fused_attn_block(b: int, s: int, w: int, heads: int):
    """(operations, bytes) of one B1 call on (B, S, W): the qkv projection,
    attention and the out projection; bytes of x, the bf16 weights, the f32
    biases and the output."""
    ops = 2 * b * s * w * 3 * w + attn_flops(b, heads, s, w // heads) \
        + 2 * b * s * w * w
    nbytes = (2 * b * s * w * BF16 + 4 * w * w * BF16 + 4 * w * F32)
    return ops, nbytes


def fused_sdpa_long(b: int, s: int, w: int, heads: int):
    """(operations, bytes) of one B8 call: q, k, v in and o out, bf16."""
    return attn_flops(b, heads, s, w // heads), 4 * b * s * w * BF16


def pq_scan_scores(rows: int, half: int, queries: int):
    """(operations, bytes) of one B11 call over ``rows`` packed code rows of
    ``half`` bytes (2 * half subspaces of 16 centroids) for ``queries``
    queries: one add a lookup; the codes, the int8 LUT and the f32 scores."""
    m = 2 * half
    return (rows * m * queries,
            rows * half + m * 16 * queries + F32 * queries * rows)
