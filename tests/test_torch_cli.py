"""The port's CLIs against clipx's, and the port's import boundary.

Both packages index one fixture folder with ``--model tiny-test`` and a
checkpoint saved by ``clipx.models.convert.save_params`` (the port with
``--device cpu``), then answer the same scripted REPL input. Stdout must be
identical line for line, with three allowances: ``Search time:`` values
differ; result-row scores agree within 1e-4 (f32 summation order); and
the progress line holds the same ``.`` and ``#`` marks, whose order
follows the decode pool's completion order in both packages.
"""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from clipx.cli import build_index as jbuild
from clipx.cli import query_index as jquery
from clipx.models import clip as jclip
from clipx.models import convert as jconvert
from clipx import config as jcfg
from clipx_torch.cli import build_index as tbuild
from clipx_torch.cli import query_index as tquery

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-4
SESSION = ["h", "a photo of a cat", "", "c 2", "two dogs", "i 1", "i 99",
           "p 5", "a", "r 640x480", "q"]


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    photos = root / "photos"
    photos.mkdir()
    rng = np.random.RandomState(0)
    for i, name in enumerate(["cat.jpg", "dog.jpeg", "bird.PNG",
                              "zebra.png", "fox.jpg"]):
        arr = rng.randint(0, 255, (40 + 4 * i, 56, 3), dtype=np.uint8)
        Image.fromarray(arr).save(photos / name)
    (photos / "broken.jpg").write_bytes(b"not really a jpeg")
    (photos / "notes.txt").write_text("not an image")
    ckpt = str(root / "tiny.npz")
    jconvert.save_params(ckpt, jclip.init_params(
        jcfg.get_config("tiny-test"), jax.random.PRNGKey(0)))
    return root, str(photos) + os.sep, ckpt


class Script:
    def __init__(self, lines):
        self.lines = list(lines)

    def __call__(self, prompt):
        print(prompt)
        if not self.lines:
            raise EOFError
        return self.lines.pop(0)


def _run(pkg, fixture_dir, monkeypatch, capsys):
    root, photos, ckpt = fixture_dir
    build, query = (jbuild, jquery) if pkg == "clipx" else (tbuild, tquery)
    flags = ["--model", "tiny-test", "--checkpoint", ckpt]
    if pkg == "port":
        flags += ["--device", "cpu"]
    work = root / pkg
    work.mkdir(exist_ok=True)
    monkeypatch.chdir(work)
    monkeypatch.setenv("CLIPX_NO_VIEWER", "1")
    capsys.readouterr()
    assert build.main(flags + [photos]) == 0
    built = capsys.readouterr().out
    args = query.build_parser().parse_args(flags)
    assert query.QueryREPL(args, input_fn=Script(SESSION)).run() == 0
    return built, capsys.readouterr().out


def _compare(ours: str, ref: str) -> None:
    a, b = ours.splitlines(), ref.splitlines()
    assert len(a) == len(b), (a, b)
    for x, y in zip(a, b):
        if y.startswith("Search time:"):
            assert x.startswith("Search time:")
            continue
        xs, ys = x.split(), y.split()
        if len(ys) == 3 and ys[1].isdigit() and "." in ys[0]:
            assert xs[1:] == ys[1:]
            assert abs(float(xs[0]) - float(ys[0])) <= SCORE_TOL
        elif set(y) <= {".", "#"}:
            assert sorted(x) == sorted(y)
        else:
            assert x == y


def test_cli_stdout_matches_clipx(fixture_dir, monkeypatch, capsys):
    ref_build, ref_query = _run("clipx", fixture_dir, monkeypatch, capsys)
    build, query = _run("port", fixture_dir, monkeypatch, capsys)
    assert "Done!" in ref_build and ref_query.count("Search time:") == 4
    _compare(build, ref_build)
    _compare(query, ref_query)
    root = fixture_dir[0]
    with open(root / "clipx" / "images.index", "rb") as f:
        ref_bytes = f.read()
    with open(root / "port" / "images.index", "rb") as f:
        ours_bytes = f.read()
    assert len(ours_bytes) == len(ref_bytes)
    np.testing.assert_allclose(np.frombuffer(ours_bytes[26:], np.float32),
                               np.frombuffer(ref_bytes[26:], np.float32),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("flag,value", [("--corpus-dtype", "int8"),
                                        ("--search-mode", "ivf"),
                                        ("--compute", "int8"),
                                        ("--preprocess", "device")])
def test_unported_flags_exit_with_a_message(flag, value, tmp_path,
                                            monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="not yet ported"):
        tbuild.main(["--device", "cpu", flag, value, str(tmp_path) + "/"])


def test_cuda_without_a_gpu_exits_with_a_message(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for main in (tbuild.main, tquery.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--model", "tiny-test"])


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_clipx():
    files = sorted((ROOT / "clipx_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if m and m.split(".")[0] in (
               "jax", "jaxlib", "flax", "clipx")]
    assert bad == []
