"""The real-weight parity gate's machinery, armed on the CPU at tiny-test.

No CLIP weights, merge table or golden file exist here, so the gate itself
(``tests/test_torch_real_weight_parity.py``) skips. These tests write the
artifacts it reads at a small size and run its code on them: a tiny-test
checkpoint from the port's seeded init, and a golden file in
``tools/make_golden.py``'s layout whose embeddings come from clipx's encoder
on that checkpoint. So the port is held to clipx through the gate's own
functions (``clipx_torch.tools.parity_check``), and the tree check, the
missing-artifact report and the missing-merges warning are held to clipx's.
"""

import gzip
import subprocess
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from clipx.cli import common as jcommon
from clipx.runtime.encoder import Encoder as JEncoder
from clipx.text import tokenizer as jtok
from clipx_torch import config as tcfg
from clipx_torch.cli import common as tcommon
from clipx_torch.models import convert as tconvert
from clipx_torch.runtime.encoder import Encoder
from clipx_torch.text import tokenizer as ttok
from clipx_torch.tools import parity_check
from tools import parity_check as jparity_check
from tools.make_golden import PROMPTS, synthetic_images

MODEL = "tiny-test"
SEED = 3
# the leaves the broken checkpoints drop and truncate
DROPPED = "visual/ln_post/bias"
TRUNCATED = "text/token_embedding"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A tiny-test checkpoint, a golden file made by clipx's encoder on it,
    the same golden with two image rows swapped, and two broken
    checkpoints: one leaf dropped, one truncated by a row."""
    tmp = tmp_path_factory.mktemp("parity")
    params = tconvert.init_params(tcfg.get_config(MODEL), SEED)
    ckpt = str(tmp / "tiny.npz")
    tconvert.save_params(ckpt, params)
    ref = JEncoder.create(MODEL, checkpoint=ckpt)
    images = synthetic_images(ref.image_size)
    golden = {"model": MODEL, "texts": np.array(PROMPTS),
              "text_emb": np.asarray(ref.encode_texts(PROMPTS)),
              "images_uint8": images,
              "image_emb": np.asarray(ref.encode_images(images))}
    paths = {"ckpt": ckpt, "golden": str(tmp / "golden.npz"),
             "swapped": str(tmp / "swapped.npz"),
             "dropped": str(tmp / "dropped.npz"),
             "truncated": str(tmp / "truncated.npz")}
    np.savez(paths["golden"], **golden)
    np.savez(paths["swapped"], **dict(
        golden, image_emb=golden["image_emb"][[1, 0, 2, 3, 4, 5]]))
    flat = tconvert._flatten(params)
    np.savez(paths["dropped"],
             **{k: v for k, v in flat.items() if k != DROPPED})
    np.savez(paths["truncated"],
             **dict(flat, **{TRUNCATED: flat[TRUNCATED][:-1]}))
    return paths


@pytest.fixture()
def no_merges(monkeypatch):
    """No merge table anywhere, for both packages' tokenizers."""
    monkeypatch.delenv("CLIPX_BPE_PATH", raising=False)
    for mod in (ttok, jtok):
        monkeypatch.setattr(mod, "_find_merge_file", lambda path: None)


def test_golden_cosines_hold_the_port_to_clipx(artifacts):
    enc = Encoder.create(parity_check.golden_model(artifacts["golden"]),
                         checkpoint=artifacts["ckpt"], device="cpu")
    cos = parity_check.golden_cosines(enc, artifacts["golden"])
    assert {k: v.shape for k, v in cos.items()} == {
        "text": (6,), "image": (6,), "image_single": (6,)}
    assert parity_check.golden_failures(cos) == []
    assert min(float(c.min()) for c in cos.values()) >= 0.999


def test_swapped_golden_rows_fail_the_gate(artifacts):
    enc = Encoder.create(MODEL, checkpoint=artifacts["ckpt"], device="cpu")
    cos = parity_check.golden_cosines(enc, artifacts["swapped"])
    failures = parity_check.golden_failures(cos)
    assert [f.split(" cosine ")[0] for f in failures] == ["image",
                                                          "image single"]
    worst = f"{cos['image'].min():.5f}"
    assert failures[0] == f"image cosine {worst} < 0.999"
    assert cos["image"].min() < 0.999 and cos["text"].min() >= 0.999


def _clipx_tree_sound(path: str, ref_shapes: dict) -> bool:
    """clipx's tree check (tests/test_real_weight_parity.py): the loaded
    Encoder's params against the preset's random init, by keystr path and
    shape."""
    params = JEncoder.create(MODEL, checkpoint=path).params
    got = {jax.tree_util.keystr(p): v.shape
           for p, v in jax.tree_util.tree_leaves_with_path(params)}
    return got == ref_shapes


def test_tree_mismatch_names_what_is_broken_as_clipx_sees_it(artifacts):
    want = dict(tconvert._flatten(tconvert.init_params(
        tcfg.get_config(MODEL))))
    assert parity_check.tree_mismatch(artifacts["ckpt"], MODEL) == {}
    assert parity_check.tree_mismatch(artifacts["dropped"], MODEL) == {
        "missing": [DROPPED]}
    full = want[TRUNCATED].shape
    assert parity_check.tree_mismatch(artifacts["truncated"], MODEL) == {
        "shapes": {TRUNCATED: ((full[0] - 1,) + full[1:], full)}}
    ref = JEncoder.create(MODEL).params
    ref_shapes = {jax.tree_util.keystr(p): v.shape
                  for p, v in jax.tree_util.tree_leaves_with_path(ref)}
    assert [_clipx_tree_sound(artifacts[k], ref_shapes)
            for k in ("ckpt", "dropped", "truncated")] == [True, False, False]


def _openai_merge_table(path) -> str:
    """A few merges in the layout of OpenAI's bpe_simple_vocab_16e6.txt.gz:
    a version line, then one pair a line."""
    merges = ["c a", "ca t</w>", "p h", "o t", "ph ot"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(path)


def test_missing_artifacts_lists_each_absent_one(artifacts, tmp_path):
    absent = str(tmp_path / "absent.npz")
    missing = parity_check.missing_artifacts(
        None, absent, ttok.ClipTokenizer(merges=[]))
    assert [m.split(":")[0] for m in missing] == [
        "- BPE merge table", "- converted checkpoint", "- golden fixture"]
    assert "clipx_torch/text/tokenizer.py" in missing[0]
    assert ("python -m clipx_torch.tools.convert_checkpoint ViT-B-32.pt "
            "--out vit_b32.npz") in missing[1]
    assert "tools/make_golden.py" in missing[2]
    assert parity_check.missing_artifacts(
        absent, absent, ttok.ClipTokenizer(merges=[]))[1] == missing[1]
    tok = ttok.ClipTokenizer(_openai_merge_table(tmp_path / "bpe.txt.gz"))
    assert tok.has_learned_merges
    assert parity_check.missing_artifacts(
        artifacts["ckpt"], artifacts["golden"], tok) == []


def test_main_reports_the_unarmed_gate_as_clipx_does(
        no_merges, monkeypatch, tmp_path, capsys):
    monkeypatch.delenv("CLIPX_CHECKPOINT", raising=False)
    monkeypatch.setenv("CLIPX_GOLDEN", str(tmp_path / "absent.npz"))
    assert jparity_check.main() == 0
    ref = capsys.readouterr().out.splitlines()
    assert parity_check.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ref[0] == "parity gate NOT armed; missing artifacts:"
    assert out[1:4] == parity_check.missing_artifacts(
        None, str(tmp_path / "absent.npz"), ttok.ClipTokenizer())
    assert out[4:] == ["(re-run `python -m clipx_torch.tools.parity_check` "
                       "once they exist)"]
    assert len(ref) == len(out)


def test_main_runs_the_gate_once_armed(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(parity_check, "missing_artifacts", lambda *a: [])
    monkeypatch.setattr(parity_check.subprocess, "call",
                        lambda argv, cwd: calls.append((argv, cwd)) or 5)
    assert parity_check.main(["--device", "cpu"]) == 5
    assert calls == [(parity_check.pytest_argv("cpu"), parity_check.ROOT)]
    assert capsys.readouterr().out == (
        "all artifacts present — running the gate\n")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_gate_selection_takes_one_golden_case(device):
    """pytest_argv's selection keeps every case of the gate but the golden
    one on the other device."""
    argv = [a for a in parity_check.pytest_argv(device) if a != "-v"]
    out = subprocess.run(argv + ["--collect-only", "-q"],
                         cwd=parity_check.ROOT, capture_output=True,
                         text=True, timeout=300)
    ids = [ln.split("::")[1] for ln in out.stdout.splitlines()
           if "::" in ln]
    assert ids == ["test_tokenizer_matches_openai_ids",
                   f"test_golden_embedding_parity[{device}]",
                   "test_checkpoint_tree_matches_preset",
                   "test_checkpoint_without_merges_warns_loudly"], out.stdout


def test_missing_merges_warning_matches_clipx(artifacts, no_merges, capsys):
    tcommon.make_encoder(SimpleNamespace(
        model=MODEL, checkpoint=artifacts["ckpt"], device="cpu"))
    ours = capsys.readouterr().err.splitlines()
    jcommon.make_encoder(SimpleNamespace(model=MODEL,
                                         checkpoint=artifacts["ckpt"]))
    ref = capsys.readouterr().err.splitlines()
    assert len(ours) == len(ref) == 1
    assert "TEXT QUERIES WILL NOT MATCH" in ours[0]
    assert "clipx_torch/text/tokenizer.py" in ours[0]
    assert ours[0].replace("clipx_torch/text/tokenizer.py",
                           "clipx/text/tokenizer.py") == ref[0]
