"""HuggingFace CLIP state dicts through both packages' converters.

A randomly initialized ``transformers.CLIPModel`` (the fixture approach of
tests/test_model_parity.py; no downloaded weights) goes through
``clipx.models.convert.from_hf_state_dict`` and
``clipx_torch.models.convert.from_state_dict``: the two param trees must be
identical, and the port's towers must reproduce the HF model's image and
text features in f32 (tolerance 2e-4, the bound test_model_parity uses for
clipx) and clipx's image embeddings (1e-5, f32 summation order only).
The vision tower has D = 64 (width 128, 2 heads), so the image path runs
through the short-attention kernels' plain versions.
"""

import numpy as np
import pytest
import torch

import jax

from clipx import config as jcfg
from clipx.models import clip as jclip
from clipx.models import convert as jconvert
from clipx_torch import config as tcfg
from clipx_torch.models import clip as tclip
from clipx_torch.models import convert as tconvert

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)


def _assert_same_tree(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


VOCAB = 512
EOS = VOCAB - 1


@pytest.fixture(scope="module")
def hf_pair():
    """A random HuggingFace CLIPModel (the fixture approach of
    tests/test_model_parity.py) and the matching configs."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPConfig(
        text_config={
            "vocab_size": VOCAB, "hidden_size": 128,
            "intermediate_size": 256, "num_hidden_layers": 2,
            "num_attention_heads": 2, "max_position_embeddings": 16,
            "hidden_act": "quick_gelu", "eos_token_id": EOS,
            "bos_token_id": EOS - 1, "pad_token_id": 0},
        vision_config={
            "hidden_size": 128, "intermediate_size": 256,
            "num_hidden_layers": 2, "num_attention_heads": 2,
            "image_size": 64, "patch_size": 16, "hidden_act": "quick_gelu"},
        projection_dim=32)
    torch.manual_seed(0)
    model = transformers.CLIPModel(hf_cfg).eval()

    def cfg(mod):
        return mod.CLIPConfig(
            name="tiny-hf",
            vision=mod.VisionConfig(image_size=64, patch_size=16, width=128,
                                    layers=2, heads=2, embed_dim=32),
            text=mod.TextConfig(context_length=16, vocab_size=VOCAB,
                                width=128, layers=2, heads=2, embed_dim=32))

    return model, cfg(jcfg), cfg(tcfg)


def test_hf_state_dict_through_both_converters(hf_pair):
    model, jc, tc = hf_pair
    sd = model.state_dict()
    jparams = jconvert.from_hf_state_dict(sd, jc)
    tparams = tconvert.from_state_dict(sd, tc)
    _assert_same_tree(jparams, tparams)

    rng = np.random.RandomState(1)
    pixels = rng.randn(2, 64, 64, 3).astype(np.float32)
    ids = np.zeros((2, 16), np.int32)
    ids[0, :5] = [EOS - 1, 5, 17, 300, EOS]
    ids[1, :3] = [EOS - 1, 42, EOS]
    with torch.no_grad():
        ref_img = model.get_image_features(
            pixel_values=torch.tensor(pixels).permute(0, 3, 1, 2))
        ref_txt = model.get_text_features(input_ids=torch.tensor(
            ids, dtype=torch.long))
    if not isinstance(ref_img, torch.Tensor):  # newer transformers: outputs
        ref_img, ref_txt = ref_img.pooler_output, ref_txt.pooler_output
    placed = tconvert.from_jax_params(tparams, tc)
    img = tclip.encode_image(placed, tc, torch.from_numpy(pixels))
    txt = tclip.encode_text(placed, tc, torch.from_numpy(ids))
    np.testing.assert_allclose(img.numpy(), ref_img.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(txt.numpy(), ref_txt.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(
        img.numpy(), np.asarray(jclip.encode_image(jparams, jc, pixels)),
        atol=1e-5, rtol=0)
