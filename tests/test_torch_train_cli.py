"""The port's train CLI (python -m clipx_torch.cli.train) on the CPU:
tests/test_train_cli.py's scenarios on synthetic caption pairs at
tiny-test, then the port against clipx's CLI from one --init-checkpoint on
one pair folder (step lines, final params), params.npz across the two
packages, clipx's orbax checkpoint refused, and clipx's dp x tp meshes.
"""

import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from clipx.cli import train as jtrain_cli
from clipx.models import convert as jconvert
from clipx_torch.cli import train as train_cli
from clipx_torch.models import convert as tconvert
from clipx_torch import config as tcfg

CPU = ["--device", "cpu"]
TINY = ["--model", "tiny-test", "--batch-size", "4", "--lr", "1e-3",
        "--warmup-steps", "1"] + CPU
# the two CLIs' losses: f32 on both sides, different summation orders
LOSS_ATOL = 1e-4
# final params after a few steps of both CLIs: Adam moves an element whose
# gradient is near 0 by up to lr either way when the summation order flips
# its sign, so the update is held to a fraction of lr (1e-3)
PARAM_ATOL = 2e-6


@pytest.fixture()
def pair_dir(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    rng = np.random.RandomState(0)
    captions = ["a red square", "a green field", "blue sky", "noise",
                "a sunset", "the ocean", "a forest", "city lights"]
    for i, cap in enumerate(captions):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                        ).save(d / f"img{i}.jpg")
        (d / f"img{i}.txt").write_text(cap)
    # an image without caption -> skipped
    Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)
                    ).save(d / "orphan.jpg")
    return str(d)


def test_find_pairs(pair_dir, capsys):
    pairs = train_cli.find_pairs(pair_dir)
    assert len(pairs) == 8
    assert "1 images without captions skipped" in capsys.readouterr().out


def test_train_runs_and_checkpoints(pair_dir, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpts")
    rc = train_cli.main([pair_dir, *TINY, "--steps", "4", "--log-every", "2",
                         "--checkpoint-dir", ckpt, "--checkpoint-every", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "step 4/4" in out and "loss" in out
    assert "mesh: dp=1 tp=1 on 1 device(s)" in out
    assert os.path.isfile(os.path.join(ckpt, "latest"))
    assert os.path.exists(os.path.join(ckpt, "params.npz"))

    # the trained params load back into the port's Encoder
    from clipx_torch.runtime.encoder import Encoder

    enc = Encoder.create("tiny-test", device="cpu",
                         checkpoint=os.path.join(ckpt, "params.npz"))
    emb = enc.encode_texts(["a red square"])
    assert emb.shape == (1, 32) and np.isfinite(emb).all()


def test_train_resume(pair_dir, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpts")
    base = [pair_dir, *TINY, "--checkpoint-dir", ckpt,
            "--checkpoint-every", "2", "--log-every", "2"]
    assert train_cli.main(base + ["--steps", "2"]) == 0
    capsys.readouterr()
    assert train_cli.main(base + ["--steps", "4", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2" in out
    assert "step 4/4" in out


def test_resume_equals_an_uninterrupted_run(pair_dir, tmp_path):
    """--resume restores the params, both Adam moments and the schedule's
    count: two steps, then two more resumed, end bit for bit where one
    state trained four steps in a row does on the same batches. (A resumed
    run's loader starts again from --seed, in clipx as here, so the
    reference restarts its loader after two steps too.)"""
    from clipx_torch import train as ttrain

    resumed = str(tmp_path / "a")
    base = [pair_dir, *TINY, "--log-every", "10"]
    assert train_cli.main(base + ["--steps", "2", "--checkpoint-dir",
                                  resumed]) == 0
    assert train_cli.main(base + ["--steps", "4", "--checkpoint-dir",
                                  resumed, "--resume"]) == 0
    # the same four batches without a checkpoint: two steps, then a fresh
    # loader for two more, on one state
    cfg = tcfg.get_config("tiny-test")
    state, tx = ttrain.create_train_state(
        cfg, 0, ttrain.make_optimizer(1e-3, 0.02, 1, 4), device="cpu")
    step = ttrain.make_train_step(cfg, tx)
    import torch

    pairs = train_cli.find_pairs(pair_dir)
    for _ in range(2):
        loader = train_cli.PairLoader(pairs, 32, 77, 4, 0)
        for _ in range(2):
            px, ids = loader.next_batch()
            state, _ = step(state, torch.from_numpy(px),
                            torch.from_numpy(ids))
    got = tconvert.load_params(os.path.join(resumed, "params.npz"))
    want = tconvert.to_jax_params(state.params)
    flat_got, flat_want = tconvert._flatten(got), tconvert._flatten(want)
    for key in flat_want:
        np.testing.assert_array_equal(flat_got[key], flat_want[key],
                                      err_msg=key)


def test_train_empty_dir(tmp_path, capsys):
    d = tmp_path / "empty"
    d.mkdir()
    assert train_cli.main([str(d), "--model", "tiny-test", *CPU]) == 1
    assert "no (image, caption) pairs" in capsys.readouterr().out


# each flag set's mesh line over 8 positions
DP_TP_MESH = {("--dp", "4", "--tp", "2"): "dp=4 tp=2 on 8",
              ("--dp", "2"): "dp=2 tp=1 on 2",
              ("--tp", "2"): "dp=4 tp=2 on 8"}


@pytest.mark.parametrize("flags", [list(f) for f in DP_TP_MESH])
def test_train_dp_tp_mesh_is_refused(pair_dir, flags, monkeypatch, capsys):
    """clipx's test_train_dp_tp_mesh on the port: over 8 positions (the one
    CPU listed 8 times, as a test-only device list) each flag set trains
    two steps at batch 8 on its mesh and prints clipx's mesh line; over the
    one visible CPU the same flags ask for more devices than there are and
    are refused with clipx's size message."""
    argv = [pair_dir, *TINY, "--steps", "2", "--batch-size", "8",
            "--log-every", "1", *flags]
    with pytest.raises(SystemExit, match=r"error: mesh \{.*\} needs \d "
                                         r"devices, have 1"):
        train_cli.main(argv)
    capsys.readouterr()
    monkeypatch.setattr(train_cli.mesh_lib, "visible_devices",
                        lambda kind="cuda": [torch.device("cpu")] * 8)
    assert train_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert f"mesh: {DP_TP_MESH[tuple(flags)]} device(s)" in out
    assert "step 2/2" in out


# meshes whose tp size splits tiny-test's 2 heads, and their mesh lines
SPLIT_MESH = {("--tp", "4"): "dp=2 tp=4 on 8",
              ("--dp", "2", "--tp", "4"): "dp=2 tp=4 on 8",
              ("--dp", "1", "--tp", "8"): "dp=1 tp=8 on 8"}


@pytest.mark.parametrize("flags", [list(f) for f in SPLIT_MESH])
def test_train_split_head_mesh_trains_like_clipx(pair_dir, tmp_path, flags,
                                                 monkeypatch, capsys):
    """A tp size that does not divide the heads trains, as clipx's CLI does
    on its 8 virtual devices: from one --init-checkpoint both CLIs print
    the same mesh line and step lines (losses within LOSS_ATOL) over 8
    positions (the one CPU listed 8 times, as a test-only device list)."""
    init = str(tmp_path / "init.npz")
    tconvert.save_params(init, tconvert.init_params(
        tcfg.get_config("tiny-test"), 0))
    argv = [pair_dir, "--model", "tiny-test", "--batch-size", "8", "--lr",
            "1e-3", "--warmup-steps", "1", "--steps", "2", "--log-every",
            "1", "--init-checkpoint", init, *flags]
    assert jtrain_cli.main(argv) == 0
    jout = capsys.readouterr().out
    monkeypatch.setattr(train_cli.mesh_lib, "visible_devices",
                        lambda kind="cuda": [torch.device("cpu")] * 8)
    assert train_cli.main(argv + CPU) == 0
    tout = capsys.readouterr().out
    line = f"mesh: {SPLIT_MESH[tuple(flags)]} device(s)"
    assert line in tout and line in jout
    js, ts = _step_lines(jout), _step_lines(tout)
    assert [s for s, _, _ in ts] == [s for s, _, _ in js] == ["1/2", "2/2"]
    for (_, jl, _), (_, tl, _) in zip(js, ts):
        assert abs(jl - tl) <= LOSS_ATOL


def test_train_cuda_without_a_gpu_raises(pair_dir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_cli.main([pair_dir, "--model", "tiny-test", "--steps", "1"])


def test_train_resume_relative_checkpoint_dir(pair_dir, tmp_path,
                                              monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    base = [pair_dir, *TINY, "--checkpoint-dir", "ckpts",
            "--checkpoint-every", "2", "--log-every", "2"]
    assert train_cli.main(base + ["--steps", "2"]) == 0
    capsys.readouterr()
    assert train_cli.main(base + ["--steps", "4", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2" in out


def test_pair_loader_pooled_decode_and_bad_file(pair_dir):
    """Cold-cache batches decode through the thread pool in one sweep;
    undecodable files are resampled, never crash the loader; the batches
    are clipx's loader's, bit for bit."""
    with open(os.path.join(pair_dir, "bad.jpg"), "wb") as f:
        f.write(b"garbage not an image")
    with open(os.path.join(pair_dir, "bad.txt"), "w") as f:
        f.write("caption of a broken file")
    pairs = train_cli.find_pairs(pair_dir)
    assert pairs == jtrain_cli.find_pairs(pair_dir)
    assert any(p[0].endswith("bad.jpg") for p in pairs)
    loader = train_cli.PairLoader(pairs, image_size=32, context_length=16,
                                  batch_size=6, seed=3, decode_workers=4)
    ref = jtrain_cli.PairLoader(pairs, image_size=32, context_length=16,
                                batch_size=6, seed=3, decode_workers=4)
    for _ in range(4):  # several batches so the bad file gets sampled
        pixels, ids = loader.next_batch()
        assert pixels.shape == (6, 32, 32, 3)
        assert ids.shape == (6, 16)
        assert np.isfinite(pixels).all()
        rp, rids = ref.next_batch()
        np.testing.assert_array_equal(pixels, rp)
        np.testing.assert_array_equal(ids, rids)
    # the bad file is cached as None (decoded once, skipped forever)
    bad = [p for p in loader._cache if p.endswith("bad.jpg")]
    assert bad and all(loader._cache[p] is None for p in bad)


def test_pair_loader_never_evicts_a_live_pick(pair_dir, monkeypatch):
    """At the cache's cap, a sweep evicts only paths it did not pick."""
    monkeypatch.setattr(train_cli.PairLoader, "_CACHE_CAP", 3)
    pairs = train_cli.find_pairs(pair_dir)
    loader = train_cli.PairLoader(pairs, 32, 16, 4, seed=0)
    for _ in range(3):
        pixels, _ = loader.next_batch()
        assert pixels.shape == (4, 32, 32, 3)
        assert all(v is not None for v in loader._cache.values())


def test_interrupt_checkpoints_and_resumes(pair_dir, tmp_path, capsys,
                                           monkeypatch):
    ckpt = str(tmp_path / "ckpts")
    base = [pair_dir, *TINY, "--checkpoint-dir", ckpt,
            "--checkpoint-every", "50", "--log-every", "50"]

    real_next = train_cli.PairLoader.next_batch
    calls = {"n": 0}

    def interrupting(self):
        calls["n"] += 1
        if calls["n"] > 3:
            raise KeyboardInterrupt
        return real_next(self)

    monkeypatch.setattr(train_cli.PairLoader, "next_batch", interrupting)
    rc = train_cli.main(base + ["--steps", "100"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "interrupt: stopping after step 3" in out
    assert os.path.exists(os.path.join(ckpt, "latest"))

    monkeypatch.setattr(train_cli.PairLoader, "next_batch", real_next)
    rc = train_cli.main(base + ["--steps", "5", "--resume"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 3" in out
    assert "step 5/5" in out


def test_sigterm_checkpoints_and_exits_zero(pair_dir, tmp_path):
    """`kill PID` on a training run stops between steps, saves a
    checkpoint, and exits 0."""
    import signal

    from tests._subproc import finish, read_until, spawn

    ckpt = str(tmp_path / "ckpts")
    code = ("from clipx_torch.cli.train import main;"
            f"raise SystemExit(main([{pair_dir!r}, '--model', 'tiny-test',"
            f"'--device', 'cpu', '--steps', '100000', '--batch-size', '4',"
            f"'--lr', '1e-3', '--warmup-steps', '1', '--log-every', '1',"
            f"'--checkpoint-every', '100000', '--checkpoint-dir',"
            f"{ckpt!r}]))")
    proc = spawn(code)
    try:
        buf = read_until(proc, lambda t: "step " in t, timeout=180)
        assert "step " in buf, buf
        proc.send_signal(signal.SIGTERM)
        out = finish(proc, timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            finish(proc, timeout=30)
    out = buf + out
    assert proc.returncode == 0, out
    assert "SIGTERM: stopping after step" in out
    assert "checkpoint ->" in out
    assert os.path.exists(os.path.join(ckpt, "latest"))
    assert os.path.exists(os.path.join(ckpt, "params.npz"))


def test_init_checkpoint_without_merges_warns(pair_dir, tmp_path, capsys):
    ckpt = str(tmp_path / "init.npz")
    tconvert.save_params(ckpt, tconvert.init_params(
        tcfg.get_config("tiny-test"), 0))
    rc = train_cli.main([pair_dir, *TINY, "--steps", "1",
                         "--init-checkpoint", ckpt])
    assert rc == 0
    out = capsys.readouterr().out
    assert "BPE merge" in out and "WARNING" in out


def _step_lines(out):
    return [(m.group(1), float(m.group(2)), m.group(3)) for m in re.finditer(
        r"step (\d+/\d+) loss ([0-9.]+) acc ([0-9.]+) \(", out)]


def test_both_clis_from_one_init_checkpoint(pair_dir, tmp_path, capsys):
    """clipx's CLI (--dp 1: one device, as the port) and the port's from
    one --init-checkpoint on one folder: the same stdout apart from the
    img/s figure (loss within LOSS_ATOL), final params within PARAM_ATOL,
    and each package loads the other's params.npz."""
    init = str(tmp_path / "init.npz")
    tconvert.save_params(init, tconvert.init_params(
        tcfg.get_config("tiny-test"), 0))
    common = [pair_dir, "--model", "tiny-test", "--batch-size", "4",
              "--lr", "1e-3", "--warmup-steps", "1", "--steps", "4",
              "--log-every", "1", "--init-checkpoint", init]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    assert jtrain_cli.main(common + ["--dp", "1", "--checkpoint-dir",
                                     jdir]) == 0
    jout = capsys.readouterr().out
    assert train_cli.main(common + CPU + ["--checkpoint-dir", tdir]) == 0
    tout = capsys.readouterr().out

    def shape(out, ckpt_dir):
        return [re.sub(r"\([0-9,]+ img/s\)", "(img/s)",
                       re.sub(r"loss [0-9.]+", "loss", line)
                       ).replace(ckpt_dir, "DIR")
                for line in out.splitlines() if "WARNING" not in line]

    assert shape(tout, tdir) == shape(jout, jdir)
    js, ts = _step_lines(jout), _step_lines(tout)
    assert len(ts) == 4 and [s for s, _, _ in ts] == [s for s, _, _ in js]
    for (_, jl, ja), (_, tl, ta) in zip(js, ts):
        assert abs(jl - tl) <= LOSS_ATOL and ja == ta

    jp = jconvert.load_params(os.path.join(jdir, "params.npz"))
    tp = tconvert.load_params(os.path.join(tdir, "params.npz"))
    start = tconvert._flatten(tconvert.load_params(init))
    jflat, tflat = tconvert._flatten(jp), tconvert._flatten(tp)
    assert set(jflat) == set(tflat) == set(start)
    for key in jflat:
        np.testing.assert_allclose(tflat[key] - start[key],
                                   jflat[key] - start[key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)

    # each package's Encoder loads the other's params.npz
    from clipx.runtime.encoder import Encoder as JEncoder
    from clipx_torch.runtime.encoder import Encoder as TEncoder

    jenc = JEncoder.create("tiny-test",
                           checkpoint=os.path.join(tdir, "params.npz"))
    tenc = TEncoder.create("tiny-test", device="cpu",
                           checkpoint=os.path.join(jdir, "params.npz"))
    for emb in (jenc.encode_texts(["a red square"]),
                tenc.encode_texts(["a red square"])):
        assert emb.shape == (1, 32) and np.isfinite(emb).all()


def test_clipx_orbax_checkpoint_is_refused(pair_dir, tmp_path, capsys):
    """--resume over clipx's orbax `latest` exits 1 with a message naming
    the format; it neither crashes nor starts over (nor overwrites it)."""
    ckpt = str(tmp_path / "ckpts")
    assert jtrain_cli.main([pair_dir, "--model", "tiny-test",
                            "--batch-size", "4", "--steps", "1", "--dp", "1",
                            "--checkpoint-dir", ckpt]) == 0
    assert os.path.isdir(os.path.join(ckpt, "latest"))
    capsys.readouterr()
    before = sorted(os.listdir(os.path.join(ckpt, "latest")))
    for extra in (["--resume"], []):
        rc = train_cli.main([pair_dir, *TINY, "--steps", "2",
                             "--checkpoint-dir", ckpt, *extra])
        assert rc == 1
        out = capsys.readouterr().out
        assert "orbax" in out and "step " not in out
    assert sorted(os.listdir(os.path.join(ckpt, "latest"))) == before
