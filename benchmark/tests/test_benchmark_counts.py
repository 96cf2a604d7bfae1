"""The yardstick's counts against values worked by hand."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import counts
from benchmark.tests.conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name)) as f:
        return json.load(f)


def test_attn_flops_by_hand():
    # b=1, h=1, s=2, d=3: QK^T 2*2*3 multiply-adds and P@V as many: 4*4*3
    assert counts.attn_flops(1, 1, 2, 3) == 48
    # causal keeps 3 of the 4 (query, key) pairs
    assert counts.attn_flops(1, 1, 2, 3, causal=True) == 36


def test_block_flops_by_hand():
    # s=2, w=4, one head: q, k, v, o 4*2*4*4*2 = 256; MLP 2*2*4*16*2 = 512;
    # attention 4*1*4*4 = 64
    assert counts.block_flops(2, 4, 1) == 256 + 512 + 64


def test_tower_flops_by_hand():
    vision = {"image_size": 4, "patch_size": 2, "width": 4, "layers": 1,
              "heads": 1, "embed_dim": 3}
    # 4 patches of 12 values into width 4, five tokens, the projection
    assert counts.image_tower_flops(vision) == (
        2 * 4 * 12 * 4 + counts.block_flops(5, 4, 1) + 2 * 4 * 3)
    text = {"context_length": 3, "width": 4, "layers": 2, "heads": 2,
            "embed_dim": 5}
    assert counts.text_tower_flops(text) == (
        2 * counts.block_flops(3, 4, 2, causal=True) + 2 * 4 * 5)


@pytest.mark.parametrize("name, gflop", [("clip-vit-b32.json", 8.8),
                                         ("clip-vit-l14-336.json", 381.0)])
def test_published_towers(name, gflop):
    """ViT-B/32's image tower is ~8.8 GFLOP an image and ViT-L/14@336px's
    ~381 (two FLOPs a multiply-add)."""
    got = counts.image_tower_flops(_config(name)["vision"]) / 1e9
    assert got == pytest.approx(gflop, rel=0.01)


def test_fused_attn_block_by_hand():
    ops, nbytes = counts.fused_attn_block(2, 3, 4, 1)
    assert ops == 2 * 6 * 4 * 12 + counts.attn_flops(2, 1, 3, 4) + 2 * 6 * 16
    # x and the output bf16, wqkv and wo bf16, the biases f32
    assert nbytes == 2 * 24 * 2 + 64 * 2 + 16 * 4


def test_fused_sdpa_long_by_hand():
    ops, nbytes = counts.fused_sdpa_long(2, 3, 8, 2)
    assert ops == 4 * 2 * 2 * 9 * 4
    assert nbytes == 4 * 2 * 3 * 8 * 2


def test_pq_scan_scores_by_hand():
    # 10 rows of 4 code bytes (8 subspaces), 3 queries
    ops, nbytes = counts.pq_scan_scores(10, 4, 3)
    assert ops == 10 * 8 * 3
    assert nbytes == 40 + 8 * 16 * 3 + 4 * 3 * 10


def test_bound_names_its_limit():
    t, by = counts.bound_s(counts.PEAK_BF16_FLOPS, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = counts.bound_s(1.0, counts.PEAK_BYTES * 2)
    assert t == pytest.approx(2.0) and by == "bytes"
