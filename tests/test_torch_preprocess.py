"""The port's device preprocessing (``--preprocess device``) against clipx's,
on the CPU in f32.

- ``device_resize_normalize``: jax.image.resize's antialiased bicubic
  (downscale, the identity, upscale) within 1e-4 of clipx's output;
- the Encoder's canvas path: square canvases of any side resampled into
  the tower, against clipx's Encoder, within 1e-4;
- ``build_index --preprocess device``: the same stdout as clipx's CLI and
  the same vectors in ``vectors.lmdb`` and ``images.index``.
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
from clipx.models import clip as jclip
from clipx.models import convert as jconvert
from clipx.ops import preprocess as jpre
from clipx.runtime.encoder import Encoder as JEncoder
from clipx.store import kv as jkv
from clipx_torch import config as tcfg
from clipx_torch.cli import build_index as tbuild
from clipx_torch.ops import packed_sdpa as tps
from clipx_torch.ops import preprocess as tpre
from clipx_torch.runtime.encoder import Encoder as TEncoder

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

TOL = 1e-4


@pytest.mark.parametrize("canvas,size", [(256, 224), (37, 32), (64, 64),
                                         (24, 32), (97, 32)])
def test_device_resize_normalize_matches_clipx(canvas, size):
    batch = np.random.RandomState(canvas).randint(
        0, 256, (2, canvas, canvas, 3), dtype=np.uint8)
    ref = np.asarray(jpre.device_resize_normalize(batch, size=size))
    out = tpre.device_resize_normalize(torch.from_numpy(batch), size)
    assert out.dtype == torch.float32 and out.shape == (2, size, size, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)
    bf = tpre.device_resize_normalize(torch.from_numpy(batch), size,
                                      dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(),
                                  out.to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("in_size,out_size", [(256, 224), (37, 32),
                                              (24, 32), (448, 336)])
def test_resize_weights_match_jax(in_size, out_size):
    """The weight matrix itself: columns are those of jax.image.resize
    applied to the identity (one unit impulse per input pixel)."""
    eye = jnp.eye(in_size, dtype=jnp.float32)[:, :, None]
    ref = np.asarray(jax.image.resize(eye, (in_size, out_size, 1),
                                      method="bicubic", antialias=True))[..., 0]
    np.testing.assert_allclose(tpre.resize_weights(in_size, out_size), ref,
                               atol=1e-6, rtol=0)


def test_non_square_canvas_raises():
    batch = np.zeros((2, 256, 320, 3), np.uint8)
    with pytest.raises(ValueError, match="square canvas"):
        jpre.device_resize_normalize(batch, 224)
    with pytest.raises(ValueError, match="square canvas"):
        tpre.device_resize_normalize(torch.from_numpy(batch), 224)
    enc = TEncoder.create("tiny-test", device="cpu")
    for shape in ((1, 32, 40, 3), (2, 37, 32, 3)):
        with pytest.raises(ValueError, match="square canvas"):
            enc.encode_images(np.zeros(shape, np.uint8))


@pytest.fixture(scope="module")
def encoders():
    params = jax.tree_util.tree_map(
        np.asarray, jclip.init_params(jcfg.get_config("tiny-test"),
                                      jax.random.PRNGKey(3)))
    buckets = (1, 4)
    return (JEncoder(jcfg.get_config("tiny-test"), params,
                     batch_buckets=buckets),
            TEncoder(tcfg.get_config("tiny-test"), params, device="cpu",
                     batch_buckets=buckets))


@pytest.mark.parametrize("n,canvas", [(1, 37), (3, 37), (4, 64), (2, 24),
                                      (3, 32)])
def test_encoder_canvas_path_matches_clipx(encoders, n, canvas):
    """Canvases of any square side go through the device resize into the
    tower (32 px itself takes the plain normalize); CPU tensors launch no
    kernel."""
    ref, ours = encoders
    images = np.random.RandomState(n * canvas).randint(
        0, 256, (n, canvas, canvas, 3), dtype=np.uint8)
    launches = dict(tps.LAUNCHES)
    out = ours.encode_images(images)
    assert tps.LAUNCHES == launches
    assert out.shape == (n, 32)
    np.testing.assert_allclose(out, ref.encode_images(images), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(ours.finalize(ours.encode_images_async(
        images)), out, atol=0, rtol=0)


def test_canvas_of_the_input_size_is_not_resampled(encoders, monkeypatch):
    _, ours = encoders
    seen = []
    from clipx_torch.runtime import encoder as tenc

    real = tenc.device_resize_normalize
    monkeypatch.setattr(tenc, "device_resize_normalize", lambda *a, **k: (
        seen.append(a[0].shape), real(*a, **k))[1])
    ours.encode_images(np.zeros((2, 32, 32, 3), np.uint8))
    assert seen == []
    ours.encode_images(np.zeros((2, 37, 37, 3), np.uint8))
    assert seen == [(4, 37, 37, 3)]


# -- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pre")
    photos = root / "photos"
    photos.mkdir()
    rng = np.random.RandomState(4)
    for i, name in enumerate(["a.jpg", "b.png", "c.jpeg", "d.PNG",
                              "e.jpg"]):
        arr = rng.randint(0, 255, (45 + 6 * i, 60, 3), dtype=np.uint8)
        Image.fromarray(arr).save(photos / name)
    (photos / "broken.png").write_bytes(b"not an image")
    ckpt = str(root / "tiny.npz")
    jconvert.save_params(ckpt, jclip.init_params(
        jcfg.get_config("tiny-test"), jax.random.PRNGKey(0)))
    return root, str(photos) + os.sep, ckpt


def _vectors(db: str):
    env = jkv.open_env(db, max_dbs=4)
    fn_db = env.open_db(b"fn_db")
    with env.begin(db=fn_db) as txn:
        rows = {k.decode(): np.frombuffer(v, np.float32).copy()
                for k, v in txn.cursor()}
    env.close()
    return rows


def test_build_index_preprocess_device_matches_clipx(fixture_dir,
                                                     monkeypatch, capsys):
    """Both CLIs decode to the 37 px canvas of tiny-test's 32 px input and
    resample on the device: the same stdout line for line (progress marks
    in completion order), the same vectors under each path."""
    root, photos, ckpt = fixture_dir
    outs, works = {}, {}
    canvases = set()
    real = TEncoder.encode_images_async
    monkeypatch.setattr(TEncoder, "encode_images_async", lambda self, b: (
        canvases.add(b.shape[1:3]), real(self, b))[1])
    for pkg, build in (("clipx", jbuild), ("port", tbuild)):
        flags = ["--model", "tiny-test", "--checkpoint", ckpt,
                 "--preprocess", "device"]
        if pkg == "port":
            flags += ["--device", "cpu"]
        work = root / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        capsys.readouterr()
        assert build.main(flags + [photos]) == 0
        outs[pkg] = capsys.readouterr().out
        works[pkg] = work
    ours, ref = outs["port"].splitlines(), outs["clipx"].splitlines()
    assert len(ours) == len(ref) and "Done!" in ref
    for x, y in zip(ours, ref):
        if set(y) <= {".", "#"}:
            assert sorted(x) == sorted(y)
        else:
            assert x == y
    assert ref[1].count(".") == 5 and ref[1].count("#") == 1
    got = _vectors(str(works["port"] / "vectors.lmdb"))
    want = _vectors(str(works["clipx"] / "vectors.lmdb"))
    assert sorted(got) == sorted(want) and len(got) == 5
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, atol=TOL, rtol=0)
    a = (works["port"] / "images.index").read_bytes()
    b = (works["clipx"] / "images.index").read_bytes()
    assert len(a) == len(b) and a[:26] == b[:26]
    np.testing.assert_allclose(np.frombuffer(a[26:], np.float32),
                               np.frombuffer(b[26:], np.float32),
                               atol=TOL, rtol=0)
    # the port's host decoded 37 px canvases, not the model's input size
    assert canvases == {(37, 37)}
