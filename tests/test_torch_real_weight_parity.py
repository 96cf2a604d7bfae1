"""Real-weight parity gate of the port, the counterpart of
``tests/test_real_weight_parity.py``.

It holds the port's encoders to OpenAI CLIP on real weights at cosine
>= 0.999, on the CPU in f32 and on the card in bf16, where the image tower
runs the hand-written attention kernels (``fused_attn_block`` for the
golden images as one batch, ``packed_sdpa`` for each alone). It needs the
three artifacts that clipx's gate needs and skips with clipx's reasons
until they exist; ``python -m clipx_torch.tools.parity_check`` lists the
missing ones and runs this file once all three exist. It imports neither
JAX nor clipx, so it runs on the card's machine:

    CLIPX_CHECKPOINT=vit_b32.npz python -m pytest --noconftest \\
        tests/test_torch_real_weight_parity.py -v
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from clipx_torch.ops import _launch
from clipx_torch.runtime.encoder import Encoder
from clipx_torch.text.tokenizer import ClipTokenizer
from clipx_torch.tools import parity_check

CKPT = os.environ.get("CLIPX_CHECKPOINT")
GOLDEN = parity_check.golden_path()

_tok = ClipTokenizer()

needs_merges = pytest.mark.skipif(
    not _tok.has_learned_merges,
    reason="learned BPE merge table not present (see module docstring)")
needs_ckpt = pytest.mark.skipif(
    not (CKPT and os.path.exists(CKPT)),
    reason="$CLIPX_CHECKPOINT not set / missing")
needs_golden = pytest.mark.skipif(
    not os.path.exists(GOLDEN),
    reason="golden fixture missing — generate with tools/make_golden.py")


@needs_merges
def test_tokenizer_matches_openai_ids():
    """Validates the supplied merge table itself: canonical CLIP ids for
    a well-known prompt (published in the OpenAI CLIP repo examples)."""
    ids = _tok(["a photo of a cat"])[0]
    expected = [49406, 320, 1125, 539, 320, 2368, 49407]
    assert ids[: len(expected)].tolist() == expected
    assert (ids[len(expected):] == 0).all()


@needs_merges
@needs_ckpt
@needs_golden
@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda",
                                                 marks=pytest.mark.cuda)])
def test_golden_embedding_parity(device):
    """The port's encoders against the stored OpenAI CLIP embeddings: f32
    on the CPU, the default bf16 on the card, where the images as one batch
    (bucket 8) must run fused_attn_block and each image alone (bucket 1)
    packed_sdpa, so that the verdict is the kernels' own."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    enc = Encoder.create(parity_check.golden_model(GOLDEN), checkpoint=CKPT,
                         device=device)
    before = _launch.launch_counts()
    cos = parity_check.golden_cosines(enc, GOLDEN)
    launched = {k: n - before[k]
                for k, n in _launch.launch_counts().items() if n != before[k]}
    failures = parity_check.golden_failures(cos)
    assert not failures, failures
    if device == "cuda":
        layers, n = enc.cfg.vision.layers, cos["image"].shape[0]
        # the prompts' chunks of 64 each replay their text bucket's graph,
        # captured after one eager pass at the bucket's first use
        t = cos["text"].shape[0]
        chunks = [min(64, t - i) for i in range(0, t, 64)]
        buckets = {min(b for b in (1, 4, 16, 64) if b >= c) for c in chunks}
        assert launched == {"fused_attn_block": layers,
                            "packed_sdpa": n * layers,
                            "text_tower_graph": len(chunks),
                            "text_tower_eager": len(buckets)}, launched
    else:
        assert launched == {}


@needs_ckpt
def test_checkpoint_tree_matches_preset():
    """Armed by the checkpoint alone: the converted tree must match the
    preset's parameter tree path for path and shape for shape, and image
    embeddings must come out unit-norm. Catches truncated or mis-converted
    weight drops the moment one exists, before the full golden gate can
    run."""
    assert parity_check.tree_mismatch(CKPT, "ViT-B/32") == {}
    enc = Encoder.create("ViT-B/32", checkpoint=CKPT, device="cpu")
    emb = enc.encode_images(
        np.zeros((1, enc.image_size, enc.image_size, 3), np.uint8))
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0,
                               atol=1e-4)


@needs_ckpt
def test_checkpoint_without_merges_warns_loudly(capsys):
    """The CLI must tell the user their text queries are garbage when a
    checkpoint is supplied without the merge table."""
    if _tok.has_learned_merges:
        pytest.skip("merges present — warning path not reachable")
    from clipx_torch.cli import common

    args = SimpleNamespace(model="ViT-B/32", checkpoint=CKPT, device="cpu")
    common.make_encoder(args)
    err = capsys.readouterr().err
    assert "TEXT QUERIES WILL NOT MATCH" in err
