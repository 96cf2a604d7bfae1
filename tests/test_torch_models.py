"""The port's layers, towers and converters against clipx, on the CPU.

The same seeded parameters (a clipx param tree, carried across with
``clipx_torch.models.convert.from_jax_params``) and the same seeded inputs
go through ``clipx.models`` and ``clipx_torch.models`` in f32. Tolerance
1e-5 absolute on unit-scale outputs (f32 summation order only). Three
configurations: ``tiny-test`` (D = 32: plain attention), a D = 64
configuration built here (image 64, patch 16, width 128, 2 heads, S = 17),
whose image tower reaches the short-attention kernels' plain versions, and
its long-sequence twin (image 160: S = 101), whose image tower reaches the
long-attention kernels' plain versions. The attention dispatch is held
against clipx's own (run with its kernels replaced by recorders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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


def _long(mod):
    """Image 160 / patch 16 (S = 101), width 128, 2 heads (D = 64)."""
    return mod.CLIPConfig(
        name="long-test",
        vision=mod.VisionConfig(image_size=160, patch_size=16, width=128,
                                layers=2, heads=2, embed_dim=64),
        text=mod.TextConfig(context_length=77, vocab_size=49408, width=64,
                            layers=2, heads=2, embed_dim=64))


def _configs(name):
    if name == "tiny-test":
        return jcfg.get_config(name), tcfg.get_config(name)
    if name == "long":
        return _long(jcfg), _long(tcfg)
    return _d64(jcfg), _d64(tcfg)


def _jax_params(cfg, seed=0):
    params = jclip.init_params(cfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=["tiny-test", "d64", "long"])
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


@pytest.mark.parametrize("route", ["auto", "qkv", "pallas"])
def test_long_tower_routes_match_clipx(route, monkeypatch):
    """S = 101 through each route of the port (fused_sdpa_long by default,
    fused_sdpa_long_qkv under CLIPX_PACKED_SDPA=qkv, flash_attention under
    attn_impl="pallas", the causal text tower included) against clipx
    with the same settings (on the CPU clipx runs plain attention, or its
    flash_attention kernel in interpret mode under "pallas")."""
    if route == "qkv":
        monkeypatch.setenv("CLIPX_PACKED_SDPA", "qkv")
    impl = "pallas" if route == "pallas" else "xla"
    jc, tc = _configs("long")
    params = _jax_params(jc, seed=2)
    tparams = tconvert.from_jax_params(params, tc)
    rng = np.random.RandomState(9)
    pixels = rng.randn(2, 160, 160, 3).astype(np.float32)
    ref = np.asarray(jclip.encode_image(params, jc, pixels, normalize=True,
                                        attn_impl=impl))
    out = tclip.encode_image(tparams, tc, torch.from_numpy(pixels),
                             normalize=True, attn_impl=impl).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    ids = np.zeros((2, 77), np.int32)
    ids[0, :3] = [49406, 320, 49407]
    ids[1, :4] = [49406, 9, 10, 49407]
    ref, _ = jclip.clip_forward(params, jc, pixels, ids, attn_impl=impl)
    out, _ = tclip.clip_forward(tparams, tc, torch.from_numpy(pixels),
                                torch.from_numpy(ids), attn_impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("attn_impl,variant", [("xla", "auto"),
                                               ("xla", "qkv"),
                                               ("pallas", "auto")])
@pytest.mark.parametrize("b,s,w,heads,causal", [
    (2, 101, 128, 2, False),  # the long kernel (or its qkv / flash forms)
    (3, 130, 256, 4, False),  # odd batch, past one 128-row q block
    (2, 77, 128, 2, True),    # causal: plain, or flash_attention
])
def test_long_blocks_match_clipx(b, s, w, heads, causal, attn_impl, variant,
                                 monkeypatch):
    """mha_block and residual_block at long sequences, each route, against
    clipx's blocks with the same settings."""
    monkeypatch.setenv("CLIPX_PACKED_SDPA", variant)
    rng = np.random.RandomState(b * s + w)
    stack = jax.tree_util.tree_map(
        np.asarray, jlayers.init_block_stack(jax.random.PRNGKey(3), 1, w))
    stack = jax.tree_util.tree_map(
        lambda a: a + rng.randn(*a.shape).astype(np.float32) * 0.02, stack)
    p0 = jax.tree_util.tree_map(lambda a: a[0], stack)
    tp0 = tlayers.layer_slice(tconvert.from_jax_params(stack), 0)
    x = rng.randn(b, s, w).astype(np.float32)
    xt = torch.from_numpy(x)
    ref = np.asarray(jlayers.mha_block(x, p0["attn"], heads, causal=causal,
                                       attn_impl=attn_impl))
    out = tlayers.mha_block(xt, tp0["attn"], heads, causal=causal,
                            attn_impl=attn_impl).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    kw = dict(causal=causal, eps=1e-5, attn_impl=attn_impl)
    ref = np.asarray(jlayers.residual_block(x, p0, heads, use_quick_gelu=True,
                                            **kw))
    out = tlayers.residual_block(xt, tp0, heads, activation="quick_gelu",
                                 **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,s,w,heads,causal", [
    (4, 17, 128, 2, False),   # even batch, even heads: fused_attn_block
    (3, 17, 128, 2, False),   # odd batch: packed_sdpa
    (2, 50, 192, 3, False),   # odd heads, even batch: fused_attn_block
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
        out = tlayers.mlp_block(xt, tp0["mlp"], "quick_gelu" if use_quick
                                else "gelu").numpy()
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    ref = np.asarray(jlayers.layer_norm(x, p0["ln_1"], 1e-5))
    out = tlayers.layer_norm(xt, tp0["ln_1"], 1e-5).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    ref = np.asarray(jlayers.transformer(x, stack, heads, causal=causal,
                                         eps=1e-5, use_quick_gelu=True))
    out = tlayers.transformer(xt, tstack, heads, causal=causal, eps=1e-5,
                              activation="quick_gelu").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


# (S, W, heads): short D = 64 with even and odd heads, short D = 32, long
# (one and two 128-row q blocks), long past clipx's 12 MiB rule for the
# packed-qkv kernel (W = 1280), and long past its 8 MiB K/V rule
# (W = 4096, where clipx leaves the TPU kernels for XLA)
_DISPATCH_SHAPES = ((17, 128, 2), (50, 192, 3), (17, 128, 4), (101, 128, 2),
                    (197, 768, 12), (577, 1280, 20), (577, 4096, 64))
_KERNELS = ("fused_attn_block", "packed_sdpa", "packed_sdpa_rows",
            "packed_sdpa_qkv", "fused_sdpa_long", "fused_sdpa_long_qkv")


def _record_clipx_routes(monkeypatch, calls):
    """clipx's dispatch as on a TPU, with every kernel, the flash kernel,
    the XLA attentions and dense replaced by shape-keeping recorders."""
    import jax.numpy as jnp

    from clipx.ops import flash_attention as jfa
    from clipx.ops import packed_sdpa as jps

    def rec(name, pick):
        return lambda *a, **k: (calls.append(name), pick(*a))[1]

    first = lambda *a: a[0]  # noqa: E731
    monkeypatch.setattr(jlayers, "_on_tpu", lambda: True)
    for name in _KERNELS:
        pick = first
        if name == "packed_sdpa_qkv":
            pick = lambda t, *a: t[..., :t.shape[-1] // 3]  # noqa: E731
        if name == "fused_sdpa_long_qkv":
            pick = lambda t, *a: t[..., :t.shape[-1] // 3]  # noqa: E731
        monkeypatch.setattr(jps, name, rec(name, pick))
    monkeypatch.setattr(jps, "fused_attn_sublayer",
                        rec("fused_attn_sublayer", first))
    monkeypatch.setattr(jfa, "flash_attention", rec("flash_attention", first))
    monkeypatch.setattr(jlayers, "xla_attention", rec("xla", first))
    monkeypatch.setattr(jlayers, "packed_pair_attention", rec("xla", first))
    monkeypatch.setattr(jlayers, "dense", lambda x, w, b=None: jnp.zeros(
        x.shape[:-1] + (w.shape[-1],), x.dtype))


def _record_port_routes(monkeypatch, calls):
    from clipx_torch.ops import flash_attention as tfa
    from clipx_torch.ops import packed_sdpa as ps

    def rec(name, pick):
        return lambda *a, **k: (calls.append(name), pick(*a))[1]

    first = lambda *a: a[0]  # noqa: E731
    for name in _KERNELS:
        pick = first
        if name in ("packed_sdpa_qkv", "fused_sdpa_long_qkv"):
            pick = lambda t, *a: t[..., :t.shape[-1] // 3]  # noqa: E731
        monkeypatch.setattr(ps, name, rec(name, pick))
    monkeypatch.setattr(ps, "fused_attn_sublayer",
                        rec("fused_attn_sublayer", first))
    monkeypatch.setattr(tfa, "flash_attention", rec("flash_attention", first))
    monkeypatch.setattr(tlayers, "xla_attention", rec("xla", first))
    monkeypatch.setattr(tlayers, "dense", lambda x, w, b=None: torch.zeros(
        x.shape[:-1] + (w.shape[-1],), dtype=x.dtype))


def _stub_block(mod, w):
    """A residual block whose weights only carry their output widths (dense
    is a recorder here)."""
    z = lambda *shape: mod(np.zeros(shape, np.float32))  # noqa: E731
    attn = {f"w{n}": z(1, w) for n in "qkvo"}
    attn.update({f"b{n}": z(w) for n in "qkvo"})
    return {"ln_1": {"scale": z(w), "bias": z(w)}, "attn": attn,
            "ln_2": {"scale": z(w), "bias": z(w)},
            "mlp": {"w1": z(1, 4 * w), "b1": z(4 * w), "w2": z(1, w),
                    "b2": z(w)}}


@pytest.mark.parametrize("attn_impl", ["xla", "pallas", "plain"])
@pytest.mark.parametrize("variant", ["auto", "block", "sublayer", "pairs",
                                     "rows", "qkv", "bogus"])
def test_mha_dispatch(monkeypatch, variant, attn_impl):
    """Every (S, batch parity, heads parity, CLIPX_PACKED_SDPA, attn_impl,
    causal) case reaches the wrapper clipx's dispatch
    (clipx/models/layers.py:104-194 and its residual_block's B5 branch)
    would choose, fused_attn_sublayer included."""
    monkeypatch.setenv("CLIPX_PACKED_SDPA", variant)
    jcalls, tcalls = [], []
    _record_clipx_routes(monkeypatch, jcalls)
    _record_port_routes(monkeypatch, tcalls)
    seen = set()
    for s, w, heads in _DISPATCH_SHAPES:
        jp, tp = _stub_block(np.asarray, w), _stub_block(torch.from_numpy, w)
        for b in (1, 2):
            for causal in (False, True):
                jcalls.clear()
                tcalls.clear()
                x = np.zeros((b, s, w), np.float32)
                kw = dict(causal=causal, eps=1e-5, attn_impl=attn_impl)
                jlayers.residual_block(x, jp, heads, use_quick_gelu=True, **kw)
                tlayers.residual_block(torch.from_numpy(x), tp, heads,
                                       activation="quick_gelu", **kw)
                assert tcalls == jcalls, (s, w, heads, b, causal)
                seen.add(jcalls[0])
    want = {"auto": {"fused_attn_block", "packed_sdpa", "fused_sdpa_long",
                     "xla"},
            "rows": {"packed_sdpa_rows", "packed_sdpa", "fused_sdpa_long",
                     "xla"},
            "pairs": {"packed_sdpa_rows", "packed_sdpa", "fused_sdpa_long",
                      "xla"},
            "qkv": {"packed_sdpa_qkv", "fused_sdpa_long_qkv",
                    "fused_sdpa_long", "packed_sdpa", "xla"},
            "sublayer": {"fused_attn_sublayer", "packed_sdpa", "xla"}}
    if attn_impl == "pallas":
        assert seen == {"flash_attention"}
    elif attn_impl == "plain":
        assert seen == {"xla"}
    else:
        assert want.get(variant, want["auto"]) <= seen


def _record_mlp_routes(monkeypatch, jcalls, tcalls):
    """Both packages' MLP and W8A8 routes with recorders: the fused MLP
    kernels, dense_w8a8, dense, and the SDPA kernels of the W8A8
    attention. clipx runs as on a TPU."""
    from clipx.models import quant as jquant
    from clipx.ops import packed_sdpa as jps
    from clipx_torch.models import quant as tquant
    from clipx_torch.ops import packed_sdpa as ps

    _record_clipx_routes(monkeypatch, jcalls)
    _record_port_routes(monkeypatch, tcalls)

    def width(name, calls, zeros):
        def rec(x, w, *a, **k):
            calls.append(name)
            return zeros(x.shape[:-1] + (w.shape[-1],))
        return rec

    def same(name, calls):
        return lambda x, *a, **k: (calls.append(name), x)[1]

    jzeros = lambda shape: jnp.zeros(shape, jnp.float32)  # noqa: E731
    monkeypatch.setattr(jquant, "dense_w8a8",
                        width("dense_w8a8", jcalls, jzeros))
    monkeypatch.setattr(tquant, "dense_w8a8",
                        width("dense_w8a8", tcalls, torch.zeros))
    monkeypatch.setattr(jlayers, "dense", width("dense", jcalls, jzeros))
    monkeypatch.setattr(tlayers, "dense", width("dense", tcalls, torch.zeros))
    for name in ("fused_mlp", "fused_mlp_w8a8"):
        monkeypatch.setattr(jps, name, same(name, jcalls))
        monkeypatch.setattr(ps, name, same(name, tcalls))


def _mlp_params(mod, w, hidden, quantized):
    z = lambda *shape: mod(np.zeros(shape, np.float32))  # noqa: E731
    if quantized:
        q = lambda *shape: mod(np.zeros(shape, np.int8))  # noqa: E731
        return {"w1_q": q(w, hidden), "s1": z(hidden), "b1": z(hidden),
                "w2_q": q(hidden, w), "s2": z(w), "b2": z(w)}
    return {"w1": z(w, hidden), "b1": z(hidden), "w2": z(hidden, w),
            "b2": z(w)}


@pytest.mark.parametrize("fused,fused_int8", [("off", "off"), ("on", "off"),
                                              ("off", "on"), ("on", "on")])
@pytest.mark.parametrize("quantized", [False, True])
def test_mlp_dispatch(monkeypatch, fused, fused_int8, quantized):
    """mlp_block takes clipx's route (clipx/models/layers.py:197-238) for
    every (CLIPX_FUSED_MLP, CLIPX_FUSED_MLP_INT8, quantized, W/H, dtype)
    case: fused_mlp where mlp_fusible allows x's dtype (ViT-B/32's both
    towers in bf16, neither in f32, ViT-L never), fused_mlp_w8a8 where
    mlp_w8a8_fusible allows it, else the unfused dense or dense_w8a8 pair.
    clipx's kernels are recorders and it runs as on a TPU."""
    monkeypatch.setenv("CLIPX_FUSED_MLP", fused)
    monkeypatch.setenv("CLIPX_FUSED_MLP_INT8", fused_int8)
    jcalls, tcalls = [], []
    _record_mlp_routes(monkeypatch, jcalls, tcalls)
    seen = set()
    for w, hidden in ((768, 3072), (512, 2048), (1024, 4096), (64, 256)):
        jp = _mlp_params(np.asarray, w, hidden, quantized)
        tp = _mlp_params(torch.from_numpy, w, hidden, quantized)
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            jcalls.clear()
            tcalls.clear()
            x = np.zeros((2, 3, w), np.float32)
            jlayers.mlp_block(x.astype(jdt), jp, True)
            tlayers.mlp_block(torch.from_numpy(x).to(tdt), tp, "quick_gelu")
            assert tcalls == jcalls, (w, hidden, tdt)
            seen.add(jcalls[0])
    if quantized:
        want = {"fused_mlp_w8a8", "dense_w8a8"} if fused_int8 == "on" else {
            "dense_w8a8"}
    else:
        want = {"fused_mlp", "dense"} if fused == "on" else {"dense"}
    assert seen == want


@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("s,w,heads", [(17, 128, 2), (50, 192, 3),
                                       (17, 64, 2), (101, 128, 2)])
def test_w8a8_attention_dispatch(monkeypatch, b, s, w, heads):
    """Quantized attention projections (CLIPX_INT8_ATTN) take clipx's SDPA
    route: packed_sdpa_rows for an even batch, packed_sdpa for an odd one
    with even heads (S <= 64, D = 64), else plain attention; and
    CLIPX_PACKED_SDPA=sublayer leaves such a block alone."""
    monkeypatch.setenv("CLIPX_PACKED_SDPA", "sublayer")
    jcalls, tcalls = [], []
    _record_mlp_routes(monkeypatch, jcalls, tcalls)
    jp, tp = _stub_block(np.asarray, w), _stub_block(torch.from_numpy, w)
    for block, mod in ((jp, np.asarray), (tp, torch.from_numpy)):
        q = _mlp_params(mod, w, w, True)  # (W, W) int8 codes, (W,) vectors
        block["attn"] = {f"{k}{n}{suffix}": q[src] for n in "qkvo"
                         for k, suffix, src in (("w", "_q", "w1_q"),
                                                ("s", "", "s2"),
                                                ("b", "", "b2"))}
    x = np.zeros((b, s, w), np.float32)
    kw = dict(causal=False, eps=1e-5)
    jlayers.residual_block(x, jp, heads, use_quick_gelu=True, **kw)
    tlayers.residual_block(torch.from_numpy(x), tp, heads,
                           activation="quick_gelu", **kw)
    assert tcalls == jcalls
    fits = s <= 64 and w // heads == 64
    want = ("packed_sdpa_rows" if fits and b % 2 == 0 else
            "packed_sdpa" if fits and heads % 2 == 0 else "xla")
    assert jcalls[:4] == ["dense_w8a8"] * 3 + [want]


def test_unknown_attn_impl_is_refused():
    x = torch.zeros((1, 17, 128))
    with pytest.raises(ValueError, match="attn_impl"):
        tlayers.mha_block(x, {}, 2, causal=False, attn_impl="flash")


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
