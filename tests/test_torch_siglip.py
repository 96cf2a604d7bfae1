"""SigLIP in the port on the CPU: a tiny SigLIP (width 144 and 2 heads, so
head dim 72; MLP 200; 60 px at patch 14, so 4 px cropped; 2 layers; context
16) against the plain reference ``benchmark/reference/siglip.py`` on
``benchmark/weights_siglip.py``'s seeded weights, its converters, its
preset, the ``tower.map_head`` span, and what the port refuses for it.

The port computes in f32 here: its gaps to the f32 reference are rounding.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import weights_siglip
from benchmark.reference import siglip as ref
from benchmark.reference.clip import _Precision
from clipx_torch import config as tcfg
from clipx_torch.models import clip, convert, layers
from clipx_torch.ops import packed_sdpa as ps
from clipx_torch.ops.preprocess import normalize_batch
from clipx_torch.runtime.encoder import Encoder
from clipx_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {
    "name": "tiny-siglip",
    "vision": {"image_size": 60, "patch_size": 14, "width": 144, "layers": 2,
               "heads": 2, "embed_dim": 144, "mlp_dim": 200,
               "class_token": False, "ln_pre": False, "patch_bias": True,
               "pool": "map"},
    "text": {"context_length": 16, "vocab_size": 512, "width": 144,
             "layers": 2, "heads": 2, "embed_dim": 144, "mlp_dim": 200,
             "causal": False, "pool": "last"},
    "quick_gelu": False, "activation": "gelu_tanh", "layernorm_eps": 1e-6,
    "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5],
    "center_crop": False, "logit_bias": True, "tokenizer": "sentencepiece",
}
CFG = tcfg.SigLIPConfig(
    name="tiny-siglip",
    vision=tcfg.SigLIPVisionConfig(**CONFIG["vision"]),
    text=tcfg.SigLIPTextConfig(**CONFIG["text"]))
ATOL = 2e-5


@pytest.fixture(scope="module")
def params():
    return weights_siglip.make_params(CONFIG, 7, torch.device("cpu"))


def _frames(n, seed=0, size=60):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8,
                         generator=gen)


def _ids(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 512, (n, 16), generator=gen)


def test_tiny_config_takes_head_dim_72_and_crops():
    v = CFG.vision
    assert v.width // v.heads == 72 and v.grid == 4 and v.seq_len == 16
    assert 60 - v.grid * v.patch_size == 4


def test_patchify_drops_the_remainder():
    x = torch.randn(2, 60, 60, 3)
    assert torch.equal(clip.patchify(x, 14), clip.patchify(x[:, :56, :56], 14))


def test_image_tower_matches_reference(params):
    frames = _frames(3)
    pixels = normalize_batch(frames, mean=CFG.image_mean, std=CFG.image_std)
    got = clip.encode_image(params, CFG, pixels, normalize=True)
    want = ref.encode_images(params, CONFIG, frames)
    assert got.dtype == torch.float32 and got.shape == (3, 144)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_map_head_alone_matches_reference(params):
    x = torch.randn(3, 16, 144, generator=torch.Generator().manual_seed(1))
    p = params["visual"]["map_head"]
    got = layers.map_head(x, p, 2, eps=1e-6, activation="gelu_tanh")
    want = ref.map_head(x, p, 2, 1e-6, _Precision(""))
    assert got.shape == (3, 144)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=1e-5)


def test_text_tower_from_ids_matches_reference(params):
    ids = _ids(4)
    got = clip.encode_text(params, CFG, ids, normalize=True)
    want = ref.encode_texts(params, CONFIG, ids)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # bidirectional: an early position sees a later id
    later = ids.clone()
    later[:, 5] = (later[:, 5] + 1) % 512
    early = clip.encode_text(params, CFG, later, normalize=True)
    assert not torch.allclose(early, got)


def test_encoder_async_finalize_matches_reference(params):
    frames = _frames(5, seed=3)
    enc = Encoder(CFG, params, device="cpu", batch_buckets=(8,))
    got = enc.finalize(enc.encode_images_async(frames.numpy()))
    want = ref.encode_images(params, CONFIG, frames).numpy()
    assert got.shape == (5, 144)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_clip_forward_adds_logit_bias(params):
    pixels, ids = torch.randn(2, 60, 60, 3), _ids(2)
    logits, per_text = clip.clip_forward(params, CFG, pixels, ids)
    img = clip.encode_image(params, CFG, pixels, normalize=True)
    txt = clip.encode_text(params, CFG, ids, normalize=True)
    torch.testing.assert_close(logits, 10.0 * img @ txt.T - 10.0)
    assert torch.equal(per_text, logits.T)


def test_init_params_has_the_siglip_tree():
    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    got = shapes(convert.init_params(CFG, 0))
    assert got == shapes(weights_siglip.make_params(CONFIG, 0, "cpu"))
    v = got["visual"]
    assert v["patch_embed"] == {"kernel": (588, 144), "bias": (144,)}
    assert v["pos_embedding"] == (16, 144)
    assert v["blocks"]["mlp"]["w1"] == (2, 144, 200)
    assert v["map_head"]["probe"] == (1, 1, 144)
    assert v["map_head"]["mlp"]["w2"] == (200, 144)
    assert got["text"]["head"] == {"kernel": (144, 144), "bias": (144,)}
    assert "class_embedding" not in v and "ln_pre" not in v


def test_preset_equals_benchmark_configuration():
    from benchmark.harness import load_json, load_module

    config = load_json(ROOT, "benchmark", "configs",
                       "siglip-so400m-14-384.json")
    driver = load_module(ROOT, "drivers", "encode_siglip")
    preset = tcfg.get_config("SigLIP-so400m/14@384")
    assert driver.program_config(config) == preset
    assert preset.vision.seq_len == 729 and preset.embed_dim == 1152
    assert preset.vision.width // preset.vision.heads == 72
    # the OpenAI presets keep exactly their fields and values
    b32 = tcfg.get_config("ViT-B/32")
    assert set(dataclasses.asdict(b32)) == {
        "name", "vision", "text", "quick_gelu", "layernorm_eps",
        "image_mean", "image_std"}
    assert (b32.activation, b32.vision.mlp_dim, b32.vision.seq_len,
            b32.center_crop, b32.text.causal) == ("quick_gelu", 3072, 50,
                                                  True, True)


def test_map_head_span_records_only_in_a_profiler_session(params):
    pixels = torch.randn(3, 60, 60, 3)
    profiling.clear_spans()
    clip.encode_image(params, CFG, pixels)
    assert profiling.recorded_spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        clip.encode_image(params, CFG, pixels)
    names = [(s.name, s.n) for s in profiling.recorded_spans()]
    profiling.clear_spans()
    assert names == [("tower.map_head", 3)]


def test_encode_texts_refuses_siglip_without_its_tokenizer(params):
    enc = Encoder(CFG, params, device="cpu", batch_buckets=(1,))
    assert enc.tokenizer is None
    with pytest.raises(ValueError, match="spiece.model"):
        enc.encode_texts(["a photo of a cat"])
    enc.warmup()  # images only


def test_fused_mlp_routes_refuse_gelu_tanh(monkeypatch, params):
    assert not ps.mlp_fusible(144, 256, torch.float32, "gelu_tanh")
    assert ps.mlp_fusible(144, 256, torch.float32, "quick_gelu")
    assert not ps.mlp_w8a8_fusible(144, 256, "gelu_tanh")
    assert ps.mlp_w8a8_fusible(144, 256, "gelu")
    m = {k: v[0] for k, v in params["visual"]["blocks"]["mlp"].items()}
    x = torch.randn(2, 5, 144)
    monkeypatch.setenv("CLIPX_FUSED_MLP", "on")
    monkeypatch.setattr(ps, "fused_mlp", None)  # the fused route is not taken
    got = layers.mlp_block(x, m, "gelu_tanh")
    h = torch.nn.functional.gelu(x @ m["w1"] + m["b1"], approximate="tanh")
    torch.testing.assert_close(got, h @ m["w2"] + m["b2"])


def _hf_state_dict(tree):
    """A Hugging Face SiglipModel state dict with the tree's values."""
    sd = {}

    def lin(key, w, b):
        sd[key + ".weight"] = w.T
        sd[key + ".bias"] = b

    def blocks(prefix, p):
        for i in range(p["ln_1"]["scale"].shape[0]):
            q = f"{prefix}.layers.{i}"
            for ln, name in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2")):
                sd[f"{q}.{name}.weight"] = p[ln]["scale"][i]
                sd[f"{q}.{name}.bias"] = p[ln]["bias"][i]
            a = p["attn"]
            for n, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                          ("o", "out_proj")):
                lin(f"{q}.self_attn.{hf}", a["w" + n][i], a["b" + n][i])
            lin(f"{q}.mlp.fc1", p["mlp"]["w1"][i], p["mlp"]["b1"][i])
            lin(f"{q}.mlp.fc2", p["mlp"]["w2"][i], p["mlp"]["b2"][i])

    v, t = tree["visual"], tree["text"]
    emb = "vision_model.embeddings"
    k = v["patch_embed"]["kernel"]
    sd[f"{emb}.patch_embedding.weight"] = k.reshape(14, 14, 3, 144).permute(
        3, 2, 0, 1)
    sd[f"{emb}.patch_embedding.bias"] = v["patch_embed"]["bias"]
    sd[f"{emb}.position_embedding.weight"] = v["pos_embedding"]
    blocks("vision_model.encoder", v["blocks"])
    sd["vision_model.post_layernorm.weight"] = v["ln_post"]["scale"]
    sd["vision_model.post_layernorm.bias"] = v["ln_post"]["bias"]
    h, a = v["map_head"], v["map_head"]["attn"]
    sd["vision_model.head.probe"] = h["probe"]
    sd["vision_model.head.attention.in_proj_weight"] = torch.cat(
        [a["wq"].T, a["wk"].T, a["wv"].T])
    sd["vision_model.head.attention.in_proj_bias"] = torch.cat(
        [a["bq"], a["bk"], a["bv"]])
    lin("vision_model.head.attention.out_proj", a["wo"], a["bo"])
    sd["vision_model.head.layernorm.weight"] = h["ln"]["scale"]
    sd["vision_model.head.layernorm.bias"] = h["ln"]["bias"]
    lin("vision_model.head.mlp.fc1", h["mlp"]["w1"], h["mlp"]["b1"])
    lin("vision_model.head.mlp.fc2", h["mlp"]["w2"], h["mlp"]["b2"])
    temb = "text_model.embeddings"
    sd[f"{temb}.token_embedding.weight"] = t["token_embedding"]
    sd[f"{temb}.position_embedding.weight"] = t["pos_embedding"]
    blocks("text_model.encoder", t["blocks"])
    sd["text_model.final_layer_norm.weight"] = t["ln_final"]["scale"]
    sd["text_model.final_layer_norm.bias"] = t["ln_final"]["bias"]
    lin("text_model.head", t["head"]["kernel"], t["head"]["bias"])
    sd["logit_scale"] = tree["logit_scale"].reshape(1)
    sd["logit_bias"] = tree["logit_bias"].reshape(1)
    return {key: val.clone() for key, val in sd.items()}


def test_hf_siglip_state_dict_converts_to_the_tree(params, tmp_path):
    sd = _hf_state_dict(params)
    assert convert.detect_format(sd) == "siglip"
    path = str(tmp_path / "siglip.pt")
    torch.save(sd, path)
    got = convert.load_torch_checkpoint(path, CFG)

    def flat(tree, pre=""):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out.update(flat(val, f"{pre}{key}/"))
            else:
                out[pre + key] = np.asarray(val, np.float32)
        return out

    want, have = flat(convert.to_jax_params(params)), flat(got)
    assert sorted(have) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    frames = _frames(2, seed=5)
    np.testing.assert_allclose(
        Encoder(CFG, got, device="cpu", batch_buckets=(2,))
        .encode_images(frames.numpy()),
        ref.encode_images(params, CONFIG, frames).numpy(), atol=ATOL)


@pytest.mark.parametrize("crop", [True, False])
def test_host_resize_crops_only_where_the_model_does(crop):
    from clipx_torch.ops.preprocess import cv2_resize_crop, pil_resize_crop

    pytest.importorskip("cv2")
    from PIL import Image

    rgb = np.zeros((40, 80, 3), np.uint8)
    rgb[:, :20] = 255  # a white band that a centre crop cuts away
    for out in (cv2_resize_crop(rgb, 32, crop),
                pil_resize_crop(Image.fromarray(rgb), 32, crop)):
        assert out.shape == (32, 32, 3)
        assert bool(out[:, 0].mean() > 200) is (not crop)


def test_siglip_config_json_is_the_configuration_file():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "siglip-so400m-14-384.json")) as f:
        config = json.load(f)
    assert config["reduced"] == []
    published = config["published"]["vision_config"]
    v = config["vision"]
    assert (v["width"], v["mlp_dim"], v["layers"], v["heads"]) == (
        published["hidden_size"], published["intermediate_size"],
        published["num_hidden_layers"], published["num_attention_heads"])
