"""The port's layers, towers and converters against clipx, on the CPU.

The same seeded parameters (a clipx param tree, carried across with
``clipx_torch.models.convert.from_jax_params``) and the same seeded inputs
go through ``clipx.models`` and ``clipx_torch.models`` in f32. Tolerance
1e-5 absolute on unit-scale outputs (f32 summation order only). Two
configurations: ``tiny-test`` (D = 32: plain attention) and a D = 64
configuration built here (image 64, patch 16, width 128, 2 heads, S = 17),
whose image tower reaches the short-attention kernels' plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from clipx import config as jcfg
from clipx.models import clip as jclip
from clipx.models import convert as jconvert
from clipx.models import layers as jlayers
from clipx_torch import config as tcfg
from clipx_torch.models import clip as tclip
from clipx_torch.models import convert as tconvert
from clipx_torch.models import layers as tlayers

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

TOL = 1e-5


def _d64(mod):
    """Image 64 / patch 16 (S = 17), width 128, 2 heads (D = 64)."""
    return mod.CLIPConfig(
        name="d64-test",
        vision=mod.VisionConfig(image_size=64, patch_size=16, width=128,
                                layers=2, heads=2, embed_dim=64),
        text=mod.TextConfig(context_length=77, vocab_size=49408, width=64,
                            layers=2, heads=2, embed_dim=64))


def _configs(name):
    if name == "tiny-test":
        return jcfg.get_config(name), tcfg.get_config(name)
    return _d64(jcfg), _d64(tcfg)


def _jax_params(cfg, seed=0):
    params = jclip.init_params(cfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=["tiny-test", "d64"])
def pair(request):
    jc, tc = _configs(request.param)
    params = _jax_params(jc)
    return jc, tc, params, tconvert.from_jax_params(params, tc)


@pytest.mark.parametrize("batch", [1, 2])  # packed_sdpa, fused_attn_block
def test_encode_image_matches_clipx(pair, batch):
    jc, tc, params, tparams = pair
    rng = np.random.RandomState(batch)
    size = jc.vision.image_size
    pixels = rng.randn(batch, size, size, 3).astype(np.float32)
    ref = np.asarray(jclip.encode_image(params, jc, pixels, normalize=True))
    out = tclip.encode_image(tparams, tc, torch.from_numpy(pixels),
                             normalize=True).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_encode_text_matches_clipx(pair):
    from clipx.text.tokenizer import ClipTokenizer

    jc, tc, params, tparams = pair
    ids = ClipTokenizer()(["a photo of a cat", "", "two dogs on a sofa"])
    ref = np.asarray(jclip.encode_text(params, jc, ids, normalize=True))
    out = tclip.encode_text(tparams, tc, torch.from_numpy(ids),
                            normalize=True).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_clip_forward_matches_clipx(pair):
    jc, tc, params, tparams = pair
    rng = np.random.RandomState(7)
    size = jc.vision.image_size
    pixels = rng.randn(2, size, size, 3).astype(np.float32)
    ids = np.zeros((2, 77), np.int32)
    ids[0, :3] = [49406, 320, 49407]
    ids[1, :4] = [49406, 9, 10, 49407]
    ref, _ = jclip.clip_forward(params, jc, pixels, ids)
    out, out_t = tclip.clip_forward(tparams, tc, torch.from_numpy(pixels),
                                    torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_array_equal(out_t.numpy(), out.numpy().T)


@pytest.mark.parametrize("b,s,w,heads,causal", [
    (4, 17, 128, 2, False),   # even batch, even heads: fused_attn_block
    (3, 17, 128, 2, False),   # odd batch: packed_sdpa
    (2, 50, 192, 3, False),   # odd heads, even batch: packed_sdpa_rows
    (3, 17, 192, 3, False),   # odd both: plain attention
    (2, 77, 64, 2, True),     # the causal text tower
])
def test_blocks_match_clipx(b, s, w, heads, causal):
    rng = np.random.RandomState(b * s + w)
    stack = jax.tree_util.tree_map(
        np.asarray, jlayers.init_block_stack(jax.random.PRNGKey(1), 2, w))
    # nonzero biases and LayerNorm affines exercise every term
    stack = jax.tree_util.tree_map(
        lambda a: a + rng.randn(*a.shape).astype(np.float32) * 0.02, stack)
    x = rng.randn(b, s, w).astype(np.float32)
    tstack = tconvert.from_jax_params(stack)
    p0 = jax.tree_util.tree_map(lambda a: a[0], stack)
    tp0 = tlayers.layer_slice(tstack, 0)
    xt = torch.from_numpy(x)

    ref = np.asarray(jlayers.mha_block(x, p0["attn"], heads, causal=causal))
    out = tlayers.mha_block(xt, tp0["attn"], heads, causal=causal).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    for use_quick in (True, False):
        ref = np.asarray(jlayers.mlp_block(x, p0["mlp"], use_quick))
        out = tlayers.mlp_block(xt, tp0["mlp"], use_quick).numpy()
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    ref = np.asarray(jlayers.layer_norm(x, p0["ln_1"], 1e-5))
    out = tlayers.layer_norm(xt, tp0["ln_1"], 1e-5).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    ref = np.asarray(jlayers.transformer(x, stack, heads, causal=causal,
                                         eps=1e-5, use_quick_gelu=True))
    out = tlayers.transformer(xt, tstack, heads, causal=causal, eps=1e-5,
                              use_quick_gelu=True).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_mha_dispatch(monkeypatch):
    """Which short-attention wrapper each (batch, heads) parity reaches."""
    from clipx_torch.ops import packed_sdpa as ps

    calls = []
    for name in ("fused_attn_block", "packed_sdpa", "packed_sdpa_rows"):
        real = getattr(ps, name)
        monkeypatch.setattr(ps, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    stack = tconvert.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jlayers.init_block_stack(jax.random.PRNGKey(2), 1, 192)))
    p = tlayers.layer_slice(stack, 0)["attn"]
    for b, heads, want in ((2, 3, "packed_sdpa_rows"), (3, 3, None)):
        calls.clear()
        tlayers.mha_block(torch.zeros((b, 17, 192)), p, heads, causal=False)
        assert calls == ([want] if want else [])
    stack = tconvert.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jlayers.init_block_stack(jax.random.PRNGKey(2), 1, 128)))
    p = tlayers.layer_slice(stack, 0)["attn"]
    for b, causal, want in ((2, False, "fused_attn_block"),
                            (1, False, "packed_sdpa"), (2, True, None)):
        calls.clear()
        tlayers.mha_block(torch.zeros((b, 17, 128)), p, 2, causal=causal)
        assert calls == ([want] if want else [])


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def _assert_same_tree(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _to_openai_state_dict(params, cfg):
    """Inverse of from_openai_state_dict (ViT), for round-trip tests."""
    v, t = cfg.vision, cfg.text
    vis, txt = params["visual"], params["text"]
    pk = vis["patch_embed"]["kernel"]
    sd = {"visual.conv1.weight": pk.reshape(v.patch_size, v.patch_size, 3,
                                            v.width).transpose(3, 2, 0, 1),
          "visual.class_embedding": vis["class_embedding"],
          "visual.positional_embedding": vis["pos_embedding"],
          "visual.ln_pre.weight": vis["ln_pre"]["scale"],
          "visual.ln_pre.bias": vis["ln_pre"]["bias"],
          "visual.ln_post.weight": vis["ln_post"]["scale"],
          "visual.ln_post.bias": vis["ln_post"]["bias"],
          "visual.proj": vis["proj"],
          "token_embedding.weight": txt["token_embedding"],
          "positional_embedding": txt["pos_embedding"],
          "ln_final.weight": txt["ln_final"]["scale"],
          "ln_final.bias": txt["ln_final"]["bias"],
          "text_projection": txt["text_projection"],
          "logit_scale": params["logit_scale"]}
    for prefix, blocks, layers in (("visual.transformer", vis["blocks"],
                                    v.layers),
                                   ("transformer", txt["blocks"], t.layers)):
        a = blocks["attn"]
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            sd[f"{p}.attn.in_proj_weight"] = np.concatenate(
                [a[k][i].T for k in ("wq", "wk", "wv")], axis=0)
            sd[f"{p}.attn.in_proj_bias"] = np.concatenate(
                [a[k][i] for k in ("bq", "bk", "bv")])
            sd[f"{p}.attn.out_proj.weight"] = a["wo"][i].T
            sd[f"{p}.attn.out_proj.bias"] = a["bo"][i]
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"] = blocks[ln]["scale"][i]
                sd[f"{p}.{ln}.bias"] = blocks[ln]["bias"][i]
            m = blocks["mlp"]
            sd[f"{p}.mlp.c_fc.weight"] = m["w1"][i].T
            sd[f"{p}.mlp.c_fc.bias"] = m["b1"][i]
            sd[f"{p}.mlp.c_proj.weight"] = m["w2"][i].T
            sd[f"{p}.mlp.c_proj.bias"] = m["b2"][i]
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_openai_state_dict_through_both_converters(tmp_path):
    jc, tc = _configs("d64")
    params = _jax_params(jc, seed=3)
    sd = _to_openai_state_dict(params, jc)
    ours = tconvert.config_from_openai_state_dict(sd)
    ref = jconvert.config_from_openai_state_dict(sd)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    _assert_same_tree(jconvert.from_openai_state_dict(sd, jc),
                      tconvert.from_state_dict(sd, tc))
    path = str(tmp_path / "tiny.pt")
    torch.save(sd, path)
    _assert_same_tree(params, tconvert.load_torch_checkpoint(path, tc))


def test_npz_params_load_in_either_package(tmp_path):
    jc, tc = _configs("tiny-test")
    params = _jax_params(jc, seed=4)
    a = str(tmp_path / "from_clipx.npz")
    jconvert.save_params(a, params)
    _assert_same_tree(params, tconvert.load_params(a))
    b = str(tmp_path / "from_port.npz")
    tconvert.save_params(b, tconvert.from_jax_params(params, tc))
    _assert_same_tree(params, jconvert.load_params(b))


@pytest.mark.parametrize("name", ["tiny-test", "d64"])
def test_init_params_has_clipx_structure(name):
    """Same tree, shapes and dtypes as clipx's init (different numbers:
    numpy's generator, not jax.random); seeded, so reproducible."""
    jc, tc = _configs(name)
    ref = jax.eval_shape(lambda k: jclip.init_params(jc, k),
                         jax.random.PRNGKey(0))
    ours = tconvert.init_params(tc, seed=5)
    lr = jax.tree_util.tree_leaves_with_path(ref)
    lo = jax.tree_util.tree_leaves_with_path(ours)
    assert [p for p, _ in lr] == [p for p, _ in lo]
    for (_, r), (_, o) in zip(lr, lo):
        assert r.shape == o.shape and o.dtype == np.float32
    _assert_same_tree(ours, tconvert.init_params(tc, seed=5))


def test_from_jax_params_dtypes():
    tc = tcfg.get_config("tiny-test")
    placed = tconvert.from_jax_params(tconvert.init_params(tc), tc,
                                      dtype=torch.bfloat16)
    v = placed["visual"]
    assert v["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert v["pos_embedding"].dtype == torch.bfloat16
    # clipx's Encoder rule: rank >= 2 in the compute dtype (stacked biases
    # included), rank 0-1 in f32
    assert v["blocks"]["attn"]["bq"].dtype == torch.bfloat16
    assert v["ln_pre"]["scale"].dtype == torch.float32
    assert v["class_embedding"].dtype == torch.float32
    assert placed["logit_scale"].dim() == 0
