"""SigLIP's arithmetic for the yardstick, from shapes alone, beside
``counts.py`` (whose peaks and ``attn_flops`` it uses): the image tower's
model FLOPs and B8's operations and bytes at SigLIP's real head dim.

The tower differs from OpenAI CLIP's: no class token (S = 729 patches at
384 px and patch 14), an MLP of ``mlp_dim`` (4304) rather than 4 x width,
and the attention-pooling head in place of the class token's projection.
B8 is counted at the head dim the model has (72), not at the 80 columns its
tiles hold on the card.
"""

from __future__ import annotations

from benchmark.counts import BF16, attn_flops


def block_flops(s: int, w: int, heads: int, hidden: int) -> int:
    """One pre-LN block a sequence: the q, k, v and out projections,
    attention, and the W -> hidden -> W MLP (matmuls only)."""
    return (2 * s * w * 4 * w + 2 * s * w * hidden * 2
            + attn_flops(1, heads, s, w // heads))


def map_head_flops(s: int, w: int, heads: int, hidden: int) -> int:
    """The pooling head a sequence: the probe's q projection, k and v over
    all S tokens, one query's attention, the out projection and the MLP of
    one row."""
    return (2 * w * w + 2 * 2 * s * w * w + 4 * heads * s * (w // heads)
            + 2 * w * w + 2 * w * hidden * 2)


def image_tower_flops(vision: dict) -> int:
    """Model FLOPs of one image through SigLIP's tower: the patch
    embedding, the blocks and the pooling head."""
    p, size, w = vision["patch_size"], vision["image_size"], vision["width"]
    s = (size // p) ** 2
    hidden = vision["mlp_dim"]
    return (2 * s * p * p * 3 * w
            + vision["layers"] * block_flops(s, w, vision["heads"], hidden)
            + map_head_flops(s, w, vision["heads"], hidden))


def fused_sdpa_long(b: int, s: int, heads: int, head_dim: int):
    """(operations, bytes) of one B8 call at the model's head dim: q, k, v
    in and o out, bf16."""
    return (attn_flops(b, heads, s, head_dim),
            4 * b * s * heads * head_dim * BF16)
