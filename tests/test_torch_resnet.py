"""The port's ResNet towers (RN50 family) against clipx's, on the CPU in f32.

An OpenAI-layout ModifiedResNet state dict with random conv weights and
random BatchNorm statistics (so the fold is exercised) goes through each
package's converter: the same clipx tree, and from it the same embeddings
from ``encode_image`` and from the Encoder (within 1e-4), on geometries
with multi-block stages (the stacked ``rest`` loop). Then config inference,
the ``from_jax_params`` layout and round trip, ``.npz`` files across the
packages, the int8 refusal, and the tiny-rn-test CLIs' stdout.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from clipx import config as jcfg
from clipx.cli import build_index as jbuild
from clipx.cli import query_index as jquery
from clipx.models import clip as jclip
from clipx.models import convert as jconvert
from clipx.models import resnet as jresnet
from clipx.runtime.encoder import Encoder as JEncoder
from clipx_torch import config as tcfg
from clipx_torch.cli import build_index as tbuild
from clipx_torch.cli import query_index as tquery
from clipx_torch.models import clip as tclip
from clipx_torch.models import convert as tconvert
from clipx_torch.models import resnet as tresnet
from clipx_torch.ops import packed_sdpa as tps
from clipx_torch.runtime.encoder import Encoder as TEncoder

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

TOL = 1e-4
# (stage blocks, width, image, embed): tiny-rn-test's geometry with a
# two-block stage 2 (tests/test_resnet.py's), and one with three-block and
# two-block stages at 64 px
GEOMETRIES = [((1, 2, 1, 1), 8, 32, 32), ((2, 1, 3, 2), 8, 64, 24)]


def _cfg(mod, layers, width, image, embed):
    return mod.CLIPConfig(
        name="rn-parity",
        vision=mod.ResNetVisionConfig(image_size=image, layers=layers,
                                      width=width, embed_dim=embed),
        text=mod.TextConfig(context_length=77, vocab_size=49408, width=32,
                            layers=2, heads=2, embed_dim=embed))


def _openai_rn_sd(layers, width, image, embed, seed=0):
    """A complete OpenAI-layout RN state dict (both towers), numpy."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[name] = (rng.randn(cout, cin, k, k) * (k * k * cin) ** -0.5
                    ).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (rng.rand(c) + 0.5).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f"{name}.running_mean"] = (rng.randn(c) * 0.2).astype(np.float32)
        sd[f"{name}.running_var"] = (rng.rand(c) + 0.5).astype(np.float32)

    conv("visual.conv1.weight", width // 2, 3, 3)
    bn("visual.bn1", width // 2)
    conv("visual.conv2.weight", width // 2, width // 2, 3)
    bn("visual.bn2", width // 2)
    conv("visual.conv3.weight", width, width // 2, 3)
    bn("visual.bn3", width)
    cin = width
    for s, n in enumerate(layers):
        planes = width * 2 ** s
        for j in range(n):
            p = f"visual.layer{s + 1}.{j}"
            conv(f"{p}.conv1.weight", planes, cin, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2.weight", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3.weight", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if j == 0:
                conv(f"{p}.downsample.0.weight", planes * 4, cin, 1)
                bn(f"{p}.downsample.1", planes * 4)
            cin = planes * 4
    c, grid = width * 32, image // 32
    ap = "visual.attnpool"
    sd[f"{ap}.positional_embedding"] = (rng.randn(grid * grid + 1, c)
                                        * c ** -0.5).astype(np.float32)
    for name, out in (("q", c), ("k", c), ("v", c), ("c", embed)):
        sd[f"{ap}.{name}_proj.weight"] = (rng.randn(out, c) * c ** -0.5
                                          ).astype(np.float32)
        sd[f"{ap}.{name}_proj.bias"] = (rng.randn(out) * 0.02
                                        ).astype(np.float32)
    w, ctx, vocab = 32, 77, 49408
    for i in range(2):
        p = f"transformer.resblocks.{i}"
        for key, shape in (("attn.in_proj_weight", (3 * w, w)),
                           ("attn.in_proj_bias", (3 * w,)),
                           ("attn.out_proj.weight", (w, w)),
                           ("attn.out_proj.bias", (w,)),
                           ("mlp.c_fc.weight", (4 * w, w)),
                           ("mlp.c_fc.bias", (4 * w,)),
                           ("mlp.c_proj.weight", (w, 4 * w)),
                           ("mlp.c_proj.bias", (w,))):
            sd[f"{p}.{key}"] = (rng.randn(*shape) * 0.05).astype(np.float32)
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = np.ones(w, np.float32)
            sd[f"{p}.{ln}.bias"] = np.zeros(w, np.float32)
    sd["ln_final.weight"] = np.ones(w, np.float32)
    sd["ln_final.bias"] = np.zeros(w, np.float32)
    sd["token_embedding.weight"] = (rng.randn(vocab, w) * 0.05
                                    ).astype(np.float32)
    sd["positional_embedding"] = (rng.randn(ctx, w) * 0.01).astype(np.float32)
    sd["text_projection"] = (rng.randn(w, embed) * 0.05).astype(np.float32)
    sd["logit_scale"] = np.asarray(2.6593, np.float32)
    return sd


def _flat(tree):
    return jconvert._flatten(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module", params=range(len(GEOMETRIES)))
def rn(request):
    geo = GEOMETRIES[request.param]
    sd = _openai_rn_sd(*geo, seed=request.param)
    jc, tc = _cfg(jcfg, *geo), _cfg(tcfg, *geo)
    return geo, sd, jc, tc, jconvert.from_openai_state_dict(sd, jc)


def test_converters_give_clipx_tree(rn):
    """The port's OpenAI RN converter (BN fold, HWIO kernels, stacked
    rest) gives clipx's tree, bit for bit."""
    _, sd, _, tc, ref = rn
    ours = tconvert.from_state_dict(sd, tc)
    want, got = _flat(ref), _flat(ours)
    assert sorted(got) == sorted(want)
    assert any("/rest/" in key for key in want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_encode_image_matches_clipx(rn):
    """The port's tower on the converted clipx tree against
    clipx.models.resnet.encode_image, f32, on random pixels."""
    geo, _, jc, tc, params = rn
    x = np.random.RandomState(1).randn(3, geo[2], geo[2], 3).astype(
        np.float32)
    want = np.asarray(jresnet.encode_image(params, jc, jnp.asarray(x)))
    launches = dict(tps.LAUNCHES)
    got = tclip.encode_image(tconvert.from_jax_params(params), tc,
                             torch.from_numpy(x)).numpy()
    assert tps.LAUNCHES == launches
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_encoder_matches_clipx(rn):
    """The Encoders end to end (normalize, tower, L2 norm) at the model's
    input size and on a square canvas (the device resize), batch buckets
    padded, and the text tower of an RN preset."""
    geo, _, jc, tc, params = rn
    ref = JEncoder(jc, params, batch_buckets=(1, 4))
    ours = TEncoder(tc, params, device="cpu", batch_buckets=(1, 4))
    rng = np.random.RandomState(2)
    for side, n in ((geo[2], 3), (geo[2], 1), (geo[2] + 9, 2)):
        images = rng.randint(0, 256, (n, side, side, 3), dtype=np.uint8)
        np.testing.assert_allclose(ours.encode_images(images),
                                   ref.encode_images(images), atol=TOL,
                                   rtol=0)
    texts = ["a photo of a cat", "two dogs"]
    np.testing.assert_allclose(ours.encode_texts(texts),
                               ref.encode_texts(texts), atol=TOL, rtol=0)


def test_config_inference_matches_clipx(rn):
    geo, sd, _, _, _ = rn
    want = jconvert.config_from_openai_state_dict(sd)
    got = tconvert.config_from_openai_state_dict(sd)
    assert got.vision.tower == "resnet"
    assert (got.vision.width, got.vision.layers, got.vision.image_size,
            got.vision.embed_dim) == (geo[1], geo[0], geo[2], geo[3])
    assert got.name == want.name
    for a, b in ((got.vision, want.vision), (got.text, want.text)):
        assert vars(a) == vars(b)


def test_from_jax_params_layout_and_round_trip(rn):
    """clipx's Encoder dtype rule (rank >= 2 in the compute dtype: stacked
    rest BN params become bf16, first-block BN stays f32); conv kernels
    keep their HWIO shape and values, laid out so that conv2d's OIHW view
    is channels_last; flattening the tensors gives clipx's tree back."""
    _, _, _, _, params = rn
    t32 = tconvert.from_jax_params(params)
    got, want = tconvert._flatten(t32), _flat(params)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)
    conv = t32["visual"]["stage2"]["first"]["conv2"]
    assert conv.shape == params["visual"]["stage2"]["first"]["conv2"].shape
    assert conv.permute(3, 2, 0, 1).is_contiguous(
        memory_format=torch.channels_last)
    rest = t32["visual"]["stage2"]["rest"] if "rest" in t32["visual"][
        "stage2"] else t32["visual"]["stage3"]["rest"]
    assert rest["conv2"][0].permute(3, 2, 0, 1).is_contiguous(
        memory_format=torch.channels_last)
    tbf = tconvert.from_jax_params(params, dtype=torch.bfloat16)
    first = tbf["visual"]["stage1"]["first"]
    assert first["conv1"].dtype == torch.bfloat16
    assert first["bn1"]["scale"].dtype == torch.float32
    stacked = tbf["visual"]["stage2"].get("rest") or tbf["visual"][
        "stage3"]["rest"]
    assert stacked["bn1"]["scale"].dtype == torch.bfloat16
    assert tbf["visual"]["attnpool"]["bq"].dtype == torch.float32


def test_npz_crosses_the_packages(rn, tmp_path):
    """An RN .npz (stacked rest keys) saved by clipx loads in the port and
    encodes the same; one saved by the port from its tensors loads in
    clipx as the same tree."""
    geo, _, jc, tc, params = rn
    path = str(tmp_path / "rn.npz")
    jconvert.save_params(path, params)
    loaded = tconvert.load_params(path)
    want = _flat(params)
    assert sorted(_flat(loaded)) == sorted(want)
    ours = TEncoder(tc, loaded, device="cpu", batch_buckets=(2,))
    ref = JEncoder(jc, params, batch_buckets=(2,))
    images = np.random.RandomState(3).randint(
        0, 256, (2, geo[2], geo[2], 3), dtype=np.uint8)
    np.testing.assert_allclose(ours.encode_images(images),
                               ref.encode_images(images), atol=TOL, rtol=0)
    back = str(tmp_path / "back.npz")
    tconvert.save_params(back, ours.params)
    for key, v in _flat(jconvert.load_params(back)).items():
        np.testing.assert_array_equal(v, want[key], err_msg=key)


@pytest.mark.parametrize("name", ["tiny-rn-test", "RN50", "RN101", "RN50x4",
                                  "RN50x16", "RN50x64"])
def test_presets_and_init_shapes_match_clipx(name):
    """The port's RN presets equal clipx's; its seeded numpy init has
    clipx's tree and shapes (checked by building both at tiny-rn-test's
    size: the full presets compare their configs only)."""
    t, j = tcfg.get_config(name), jcfg.get_config(name)
    assert vars(t.vision) == vars(j.vision) and vars(t.text) == vars(j.text)
    assert t.vision.heads == j.vision.heads
    assert t.text.heads == t.text.width // 64 or name == "tiny-rn-test"
    if name != "tiny-rn-test":
        return
    ours = tconvert.init_params(t, seed=0)
    ref = jax.tree_util.tree_map(np.asarray,
                                 jclip.init_params(j, jax.random.PRNGKey(0)))
    a, b = _flat(ours), _flat(ref)
    assert sorted(a) == sorted(b)
    assert all(a[key].shape == b[key].shape for key in b)
    emb = TEncoder(t, ours, device="cpu").encode_images(
        np.zeros((2, 32, 32, 3), np.uint8))
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)


def test_compute_int8_is_refused_for_resnet(monkeypatch):
    for build in (lambda: JEncoder.create("tiny-rn-test",
                                          compute_quant="int8"),
                  lambda: TEncoder.create("tiny-rn-test", device="cpu",
                                          compute_quant="int8")):
        with pytest.raises(ValueError, match="ViT towers"):
            build()
    monkeypatch.setenv("CLIPX_COMPUTE", "int8")
    with pytest.raises(ValueError, match="ViT towers"):
        TEncoder.create("tiny-rn-test", device="cpu")
    monkeypatch.setenv("CLIPX_COMPUTE", "bf16")
    TEncoder.create("tiny-rn-test", device="cpu")


class Script:
    def __init__(self, lines):
        self.lines = list(lines)

    def __call__(self, prompt):
        print(prompt)
        if not self.lines:
            raise EOFError
        return self.lines.pop(0)


def test_tiny_rn_cli_stdout_matches_clipx(tmp_path, monkeypatch, capsys):
    """build_index and a scripted REPL under --model tiny-rn-test with a
    clipx checkpoint: the same stdout from both packages (scores within
    1e-4, progress marks in completion order)."""
    photos = tmp_path / "photos"
    photos.mkdir()
    rng = np.random.RandomState(11)
    for i in range(4):
        Image.fromarray(rng.randint(0, 255, (40 + 4 * i, 40, 3), np.uint8)
                        ).save(photos / f"p{i}.jpg")
    ckpt = str(tmp_path / "rn.npz")
    jconvert.save_params(ckpt, jclip.init_params(
        jcfg.get_config("tiny-rn-test"), jax.random.PRNGKey(0)))
    monkeypatch.setenv("CLIPX_NO_VIEWER", "1")
    outs = {}
    for pkg, build, query in (("clipx", jbuild, jquery),
                              ("port", tbuild, tquery)):
        flags = ["--model", "tiny-rn-test", "--checkpoint", ckpt]
        if pkg == "port":
            flags += ["--device", "cpu"]
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        capsys.readouterr()
        assert build.main(flags + [str(photos) + os.sep]) == 0
        args = query.build_parser().parse_args(flags)
        assert query.QueryREPL(args, input_fn=Script(
            ["c 2", "a photo", "i 1", "q"])).run() == 0
        outs[pkg] = capsys.readouterr().out
    ours, ref = outs["port"].splitlines(), outs["clipx"].splitlines()
    assert len(ours) == len(ref) and ref.count("Done!") == 1
    assert sum(line.startswith("Search time:") for line in ref) == 2
    for x, y in zip(ours, ref):
        if y.startswith("Search time:"):
            assert x.startswith("Search time:")
            continue
        xs, ys = x.split(), y.split()
        if len(ys) == 3 and ys[1].isdigit() and "." in ys[0]:
            assert xs[1:] == ys[1:]
            assert abs(float(xs[0]) - float(ys[0])) <= TOL
        elif set(y) <= {".", "#"}:
            assert sorted(x) == sorted(y)
        else:
            assert x == y


def test_resnet_tower_names_match_clipx():
    """The same public and private functions as clipx.models.resnet."""
    for name in ("conv2d", "_bn", "_conv_bn", "avg_pool", "_bottleneck",
                 "_stage", "_attention_pool", "encode_image", "fold_bn",
                 "init_visual"):
        assert callable(getattr(tresnet, name)) and hasattr(jresnet, name)
    g = np.random.RandomState(0)
    args = [g.rand(4).astype(np.float32) + 0.5 for _ in range(4)]
    for key, v in jresnet.fold_bn(*args).items():
        np.testing.assert_array_equal(tresnet.fold_bn(*args)[key], v)
