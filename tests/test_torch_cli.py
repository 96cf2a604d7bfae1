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


def _run(pkg, fixture_dir, monkeypatch, capsys, tier="f32",
         session=SESSION, extra=(), tag="", before_query=None):
    """Build the fixture folder and run a scripted REPL with one package
    (``extra`` flags added to both commands) in a work directory of its
    own (named by the package, the tier, the flags and ``tag``), calling
    ``before_query(work)`` between the two; returns (build stdout, REPL
    stdout, build and REPL stderr)."""
    root, photos, ckpt = fixture_dir
    build, query = (jbuild, jquery) if pkg == "clipx" else (tbuild, tquery)
    flags = ["--model", "tiny-test", "--checkpoint", ckpt,
             "--corpus-dtype", tier, *extra]
    if pkg == "port":
        flags += ["--device", "cpu"]
    work = root / "-".join(filter(None, [pkg, tier, *extra, tag]))
    work.mkdir(exist_ok=True)
    monkeypatch.chdir(work)
    monkeypatch.setenv("CLIPX_NO_VIEWER", "1")
    capsys.readouterr()
    assert build.main(flags + [photos]) == 0
    built = capsys.readouterr()
    if before_query is not None:
        before_query(work)
    args = query.build_parser().parse_args(flags)
    assert query.QueryREPL(args, input_fn=Script(session)).run() == 0
    out = capsys.readouterr()
    return built.out, out.out, built.err + out.err


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
    ref_build, ref_query, _ = _run("clipx", fixture_dir, monkeypatch, capsys)
    build, query, _ = _run("port", fixture_dir, monkeypatch, capsys)
    assert "Done!" in ref_build and ref_query.count("Search time:") == 4
    _compare(build, ref_build)
    _compare(query, ref_query)
    root = fixture_dir[0]
    with open(root / "clipx-f32" / "images.index", "rb") as f:
        ref_bytes = f.read()
    with open(root / "port-f32" / "images.index", "rb") as f:
        ours_bytes = f.read()
    assert len(ours_bytes) == len(ref_bytes)
    np.testing.assert_allclose(np.frombuffer(ours_bytes[26:], np.float32),
                               np.frombuffer(ref_bytes[26:], np.float32),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("tier", ["pq", "int8"])
def test_coded_tier_cli_stdout_matches_clipx(fixture_dir, monkeypatch,
                                             capsys, tier):
    """--corpus-dtype pq / int8: the build also writes images.index.codes
    ("Encoding {tier} codes..." on stdout), the REPL loads it (stderr) and
    prints clipx's result rows."""
    session = ["a photo of a cat", "i 1", "q"]
    ref_build, ref_query, ref_err = _run("clipx", fixture_dir, monkeypatch,
                                         capsys, tier, session)
    build, query, err = _run("port", fixture_dir, monkeypatch, capsys, tier,
                             session)
    assert f"Encoding {tier} codes..." in ref_build.splitlines()
    _compare(build, ref_build)
    _compare(query, ref_query)
    assert query.count("Search time:") == 2
    for e in (err, ref_err):
        assert f"(loaded 5 {tier} rows from images.index.codes)" in e


@pytest.mark.parametrize("fused", ["off", "on"])
def test_compute_int8_cli_stdout_matches_clipx(fixture_dir, monkeypatch,
                                               capsys, fused):
    """--compute int8: both packages index and answer with the W8A8 image
    tower (with CLIPX_FUSED_MLP_INT8=on the port takes its fused kernel's
    plain version, clipx its unfused path off the TPU); the same stdout."""
    monkeypatch.setenv("CLIPX_FUSED_MLP_INT8", fused)
    session = ["a photo of a cat", "i 1", "i 3", "q"]
    extra = ("--compute", "int8")
    ref_build, ref_query, _ = _run("clipx", fixture_dir, monkeypatch, capsys,
                                   session=session, extra=extra, tag=fused)
    build, query, _ = _run("port", fixture_dir, monkeypatch, capsys,
                           session=session, extra=extra, tag=fused)
    assert build.count(".") >= 5  # every image encoded in this run
    _compare(build, ref_build)
    _compare(query, ref_query)
    assert query.count("Search time:") == 3


@pytest.mark.parametrize("tier", ["f32", "pq"])
def test_search_mode_ivf_cli_stdout_matches_clipx(fixture_dir, monkeypatch,
                                                  capsys, tier):
    """--search-mode ivf: each package builds the fixture folder (the same
    stdout), then each REPL queries clipx's images.index through one .ivf
    cache: clipx's REPL trains and writes it (for pq with residual codes in
    images.index.codes), and the port's REPL, handed those files, loads
    them. The same stdout, with 'p N' setting the live nprobe."""
    session = ["p 5", "a photo of a cat", "i 1", "p 100", "two dogs", "q"]
    extra = ("--search-mode", "ivf")
    ref_build, ref_query, _ = _run("clipx", fixture_dir, monkeypatch, capsys,
                                   tier, session, extra)
    ref_work = fixture_dir[0] / "-".join(["clipx", tier, *extra])
    shared = ["images.index", "images.index.ivf"] + (
        ["images.index.codes"] if tier == "pq" else [])

    def use_clipx_index(work):
        for name in shared:
            (work / name).write_bytes((ref_work / name).read_bytes())

    build, query, err = _run("port", fixture_dir, monkeypatch, capsys, tier,
                             session, extra, before_query=use_clipx_index)
    _compare(build, ref_build)
    _compare(query, ref_query)
    assert query.count("Search time:") == 3
    assert query.count("Set to probe") == 2
    work = fixture_dir[0] / "-".join(["port", tier, *extra])
    for name in shared:  # loaded, not rebuilt
        assert (work / name).read_bytes() == (ref_work / name).read_bytes()
    if tier == "pq":
        assert "(loaded 5 pq rows from images.index.codes)" in err


def test_sharded_cli_stdout_matches_unsharded_and_clipx(fixture_dir,
                                                       monkeypatch, capsys):
    """--sharded on for both commands (tests/test_cli_contract.py's sharded
    REPL case): the port's indexer encodes data-parallel over its one CPU
    shard and says so on stderr, as clipx's does over its 8 virtual
    devices; the REPL prints the rows of --sharded off, and clipx's."""
    on = ("--sharded", "on")
    ref_build, ref_query, ref_err = _run("clipx", fixture_dir, monkeypatch,
                                         capsys, extra=on)
    build, query, err = _run("port", fixture_dir, monkeypatch, capsys,
                             extra=on)
    _, off_query, off_err = _run("port", fixture_dir, monkeypatch, capsys,
                                 extra=("--sharded", "off"))
    _compare(build, ref_build)
    _compare(query, ref_query)
    _compare(query, off_query)
    assert query.count("Search time:") == 4
    assert "(data-parallel encode over 8 devices)" in ref_err
    assert "(data-parallel encode over 1 devices)" in err
    assert "data-parallel" not in off_err


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
    """No module of the port, nor chip_smoke.py, nor the port's
    multi-process test worker, nor its real-weight parity gate, imports
    JAX, clipx or a script of the root tools/ folder (by package or by
    module name)."""
    files = sorted((ROOT / "clipx_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist_worker.py",
        ROOT / "tests" / "test_torch_real_weight_parity.py"]
    names = {str(f.relative_to(ROOT)) for f in files}
    assert len(files) > 20
    assert {"clipx_torch/models/resnet.py",
            "clipx_torch/parallel/mesh.py", "clipx_torch/parallel/mips.py",
            "clipx_torch/parallel/distributed.py",
            "clipx_torch/parallel/tensor.py",
            "tests/_torch_dist_worker.py",
            "tests/test_torch_real_weight_parity.py",
            "clipx_torch/tools/eval_quality.py", "clipx_torch/train.py",
            "clipx_torch/cli/train.py", "clipx_torch/utils/env.py",
            *(f"clipx_torch/tools/{t}.py" for t in (
                "make_synth_index", "load_timing", "find_dupes", "kv_tool",
                "build_codes_direct", "convert_checkpoint",
                "parity_check"))} <= names
    root_tools = {p.stem for p in (ROOT / "tools").glob("*.py")}
    assert {"eval_quality", "kv_tool", "build_codes_direct",
            "parity_check", "make_golden"} <= root_tools
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imports(f) if m and m.split(".")[0] in (
               "jax", "jaxlib", "flax", "clipx", "tools", *root_tools)]
    assert bad == []
