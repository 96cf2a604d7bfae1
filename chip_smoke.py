"""Smoke run of the PyTorch/CUDA port (clipx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from clipx_torch/csrc with nvcc, then runs
these phases, printing one JSON line per phase:

1. env      — torch / CUDA / nvcc versions, the card's name and power
              limit, which optional host packages import.
2. kernels  — each kernel at the shapes the main path gives it, against its
              plain PyTorch version on the card (stated bf16 tolerance) and
              against an f32 plain run; CUDA-event medians of the kernel,
              the plain version and one PyTorch library call, and their
              device times from torch.profiler.
3. encode   — the Encoder at ViT-B/32 full width (seeded random weights):
              1,024 seeded images in batches of 128, then one batch of 1;
              launch counts checked; a few images against the port's CPU f32
              encode of the same weights (cosine >= 0.99).
4. text     — encode_texts latency with the port's tokenizer.
5. search   — the phase-3 embeddings through the port's KV store and
              images.index writer and back; exact and int8-seg ("quant")
              search at 1,000,000 x 512 + those rows, k=50, 16 queries.
6. profile  — torch.profiler over two 128-image encodes: device time by
              kernel name, and the card's busy share of the host's wall
              per batch without the profiler (and with it).
7. cli      — build_index and a scripted query_index REPL at ViT-B/32 on a
              few fixture images (only when PIL or cv2 imports).

Phases 3-5 are the main path: every launch count is set to 0 just before
phase 3 and read just after phase 5. The line before the last lists every
kernel ({"kernels": [...]}) with those counts; the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the run exits
non-zero and prints no result line; so does a machine without a GPU, or a
directory without the clipx_torch package beside this script.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense): bf16 tensor cores, f32 outside
# them, HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SEED = 0
# bf16 tolerances: kernel vs plain version on the same bf16 inputs (they
# differ only in f32 summation order, which can flip a bf16 rounding of an
# intermediate or of the output: ~2.5 ulps at |y| ~ 1), and either vs an
# f32 plain run (adds the bf16 rounding of qkv, probabilities and head
# outputs themselves)
ATOL_PLAIN, RTOL_PLAIN = 1e-2, 2e-2
ATOL_F32, RTOL_F32 = 3e-2, 3e-2

VIT_B32_HEADS = 12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def cuda_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of one call of fn, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _profiled(fn, iters: int):
    """torch.profiler over iters calls of fn: (CUDA time by kernel name in
    ms per call, calls per call of fn, host wall in ms per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                       e.count / iters) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    return kernels, wall * 1e3 / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call of fn, in ms: the sum of the CUDA kernels
    it launches, read by torch.profiler (mean of iters calls). Unlike
    cuda_ms it leaves out the host's work between launches."""
    fn()
    torch.cuda.synchronize()
    kernels, _ = _profiled(fn, iters)
    ms = sum(t for _, t, _ in kernels)
    check(ms > 0, "torch.profiler saw no device time")
    return ms


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# phase 1: environment
# ---------------------------------------------------------------------------

def phase_env() -> dict:
    from clipx_torch.ops import _build

    def imports(mod):
        try:
            __import__(mod)
            return True
        except ImportError:
            return False

    nvcc = _build.nvcc()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    info = {
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc_v.splitlines()[-1],
        "card": card_line(),
        "device_count": torch.cuda.device_count(),
        "host_packages": {m: imports(m) for m in
                          ("PIL", "cv2", "regex", "triton", "transformers")},
        "gxx": shutil.which("g++") is not None,
    }
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _close(out, ref, atol, rtol):
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return ok, float(err.max())


def _bf16(gen, shape, scale, device):
    return (torch.randn(shape, generator=gen) * scale).to(device,
                                                          torch.bfloat16)


def _times(kernel, plain, library) -> dict:
    """CUDA-event medians (host work between launches included) and
    profiler device times of the kernel, its plain version and the library
    yardstick."""
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library), "device_ms": device_ms(kernel),
            "plain_device_ms": device_ms(plain),
            "library_device_ms": device_ms(library)}


def phase_kernels(device) -> dict:
    import torch.nn.functional as F

    from clipx_torch.ops import _build
    from clipx_torch.ops import packed_sdpa as ps

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in logs.items()}
    gen = torch.Generator().manual_seed(SEED)
    results = {}

    # B1: fused_attn_block at the indexing batch (128, 50, 768), 12 heads
    b, s, w, h = 128, 50, 768, VIT_B32_HEADS
    x = _bf16(gen, (b, s, w), 1.0, device)
    wqkv = _bf16(gen, (w, 3 * w), 0.03, device)
    wo = _bf16(gen, (w, w), 0.03, device)
    bqkv = (torch.randn(3 * w, generator=gen) * 0.01).to(device)
    bo = (torch.randn(w, generator=gen) * 0.01).to(device)
    args = (x, wqkv, bqkv, wo, bo)
    out = ps.fused_attn_block(*args, heads=h)
    plain = ps.fused_attn_block_plain(*args, heads=h)
    truth = ps.fused_attn_block_plain(*(t.float() for t in args), heads=h)
    torch.cuda.synchronize()
    ok_p, err_p = _close(out, plain, ATOL_PLAIN, RTOL_PLAIN)
    ok_k, err_k = _close(out, truth, ATOL_F32, RTOL_F32)
    ok_t, err_t = _close(plain, truth, ATOL_F32, RTOL_F32)
    bqkv16, bo16 = bqkv.to(torch.bfloat16), bo.to(torch.bfloat16)

    def lib_b1():
        qkv = torch.addmm(bqkv16, x.view(b * s, w), wqkv)
        q, k, v = qkv.view(b, s, 3, h, 64).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return torch.addmm(bo16, o.transpose(1, 2).reshape(b * s, w), wo)

    flops = (2 * b * s * w * 3 * w + 2 * b * s * w * w
             + 4 * b * h * s * s * 64)
    nbytes = (2 * b * s * w * 2 + (3 * w * w + w * w) * 2
              + (3 * w + w) * 4)
    bms, by = bound(flops, nbytes)
    results["fused_attn_block"] = {
        "shape": [b, s, w, h], "max_abs_err": err_p,
        "max_abs_err_vs_f32": err_k, "plain_err_vs_f32": err_t,
        **_times(lambda: ps.fused_attn_block(*args, heads=h),
                 lambda: ps.fused_attn_block_plain(*args, heads=h), lib_b1),
        "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes,
    }
    check(ok_p, f"fused_attn_block vs plain: max err {err_p}")
    check(ok_k and ok_t, f"fused_attn_block vs f32: {err_k}, {err_t}")

    # B2 at the encoder's bucket 1, B3 at an even batch: (B, 50, 768)
    for name, fn, b in (("packed_sdpa", ps.packed_sdpa, 1),
                        ("packed_sdpa_rows", ps.packed_sdpa_rows, 2)):
        q, k, v = (_bf16(gen, (b, s, w), 1.0, device) for _ in range(3))
        out = fn(q, k, v, heads=h)
        plain = ps.sdpa_plain(q, k, v, heads=h)
        truth = ps.sdpa_plain(q.float(), k.float(), v.float(), heads=h)
        torch.cuda.synchronize()
        ok_p, err_p = _close(out, plain, ATOL_PLAIN, RTOL_PLAIN)
        ok_k, err_k = _close(out, truth, ATOL_F32, RTOL_F32)

        def lib(q=q, k=k, v=v, b=b):
            def split(t):
                return t.view(b, s, h, 64).transpose(1, 2)
            return F.scaled_dot_product_attention(
                split(q), split(k), split(v)).transpose(1, 2)

        flops = 4 * b * h * s * s * 64
        nbytes = 4 * b * s * w * 2
        bms, by = bound(flops, nbytes)
        results[name] = {
            "shape": [b, s, w, h], "max_abs_err": err_p,
            "max_abs_err_vs_f32": err_k,
            **_times(lambda: fn(q, k, v, heads=h),
                     lambda: ps.sdpa_plain(q, k, v, heads=h), lib),
            "bound_ms": bms, "bound_by": by, "flops": flops,
            "bytes": nbytes,
        }
        check(ok_p, f"{name} vs plain: max err {err_p}")
        check(ok_k, f"{name} vs f32: max err {err_k}")

    # the rows and pairs wrappers launch one kernel: same bits on one input
    q, k, v = (_bf16(gen, (2, s, w), 1.0, device) for _ in range(3))
    check(torch.equal(ps.packed_sdpa(q, k, v, heads=h),
                      ps.packed_sdpa_rows(q, k, v, heads=h)),
          "packed_sdpa and packed_sdpa_rows disagree")
    emit({"phase": "kernels", "build_s": build_s, "ptxas": ptxas,
          "tolerance": {"vs_plain": [ATOL_PLAIN, RTOL_PLAIN],
                        "vs_f32": [ATOL_F32, RTOL_F32]},
          "results": results})
    return results


KERNEL_TABLE = (
    # name, source, the Pallas kernel it replaces
    ("fused_attn_block", "clipx_torch/csrc/attn_block.cu",
     "clipx/ops/packed_sdpa.py:312"),
    ("packed_sdpa", "clipx_torch/csrc/short_sdpa.cu",
     "clipx/ops/packed_sdpa.py:763"),
    ("packed_sdpa_rows", "clipx_torch/csrc/short_sdpa.cu",
     "clipx/ops/packed_sdpa.py:548"),
)


def kernels_line(results: dict, launches: dict) -> dict:
    rows = []
    for name, source, replaces in KERNEL_TABLE:
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "device_ms": r["device_ms"],
                     "plain_device_ms": r["plain_device_ms"],
                     "library_device_ms": r["library_device_ms"]})
    return {"kernels": rows}


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

N_IMAGES, BATCH, CPU_CHECK = 1024, 128, 4
CORPUS_ROWS, DIM, K, NQ = 1_000_000, 512, 50, 16
COS_MIN = 0.99        # card bf16 vs CPU f32 embeddings of the same images
NEAR_DUP_ATOL = 5e-4  # the near-duplicate exception tests/test_quality_gate pins


def make_encoder(device):
    from clipx_torch.runtime.encoder import Encoder

    t0 = time.perf_counter()
    enc = Encoder.create("ViT-B/32", seed=SEED, device=device)
    enc.warmup(buckets=(1, BATCH))
    torch.cuda.synchronize()
    return enc, time.perf_counter() - t0


def phase_encode(enc, images: np.ndarray) -> dict:
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.runtime.encoder import Encoder

    heads, layers = enc.cfg.vision.heads, enc.cfg.vision.layers
    b1_before = ps.LAUNCHES["fused_attn_block"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = np.concatenate([enc.encode_images(images[i: i + BATCH])
                           for i in range(0, N_IMAGES, BATCH)])
    secs = time.perf_counter() - t0
    b1 = ps.LAUNCHES["fused_attn_block"] - b1_before
    check(b1 == layers * (N_IMAGES // BATCH),
          f"fused_attn_block launched {b1} times for {N_IMAGES // BATCH} "
          f"batches of {BATCH}, expected {layers} per batch")

    b2_before = ps.LAUNCHES["packed_sdpa"]
    t1 = time.perf_counter()
    one = enc.encode_images(images[:1])
    one_s = time.perf_counter() - t1
    b2 = ps.LAUNCHES["packed_sdpa"] - b2_before
    check(b2 == layers, f"packed_sdpa launched {b2} times for a batch of "
                        f"1, expected {layers}")
    check(embs.shape == (N_IMAGES, enc.embed_dim)
          and bool(np.isfinite(embs).all()), "bad image embeddings")
    check(bool(np.allclose(np.linalg.norm(embs, axis=1), 1.0, atol=1e-3)),
          "image embeddings are not unit-norm")
    cos_one = float(one[0] @ embs[0])
    check(cos_one >= COS_MIN, f"batch-1 vs batch-128 cosine {cos_one}")

    # the same weights in f32 on the CPU, for a few of the same images
    cpu = Encoder.create("ViT-B/32", seed=SEED, device="cpu")
    ref = cpu.encode_images(images[:CPU_CHECK])
    cos = (ref * embs[:CPU_CHECK]).sum(axis=1)
    check(bool((cos >= COS_MIN).all()), f"card vs CPU f32 cosine {cos}")
    info = {"phase": "encode", "model": "ViT-B/32", "images": N_IMAGES,
            "batch": BATCH, "seconds": secs, "img_per_s": N_IMAGES / secs,
            "batch1_ms": one_s * 1e3, "attn_launches_per_batch":
            b1 / (N_IMAGES // BATCH), "packed_sdpa_launches_batch1": b2,
            "cos_vs_cpu_f32_min": float(cos.min()), "cos_tolerance": COS_MIN,
            "cos_batch1_vs_batch128": cos_one}
    emit(info)
    return {"embs": embs, "info": info}


def phase_text(enc) -> dict:
    for _ in range(3):
        enc.encode_texts(["a photo of a cat"])
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        e = enc.encode_texts(["a photo of a cat"])
        times.append(time.perf_counter() - t0)
    check(e.shape == (1, enc.embed_dim) and bool(np.isfinite(e).all())
          and abs(float(np.linalg.norm(e)) - 1.0) < 1e-3,
          "bad text embedding")
    info = {"phase": "text", "calls": len(times),
            "p50_ms": statistics.median(times) * 1e3,
            "min_ms": min(times) * 1e3}
    emit(info)
    return info


def _search_p50(index, queries, k, reps=30):
    for _ in range(3):
        index.search(queries, k)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        D, I = index.search(queries, k)
        times.append(time.perf_counter() - t0)
    return D, I, statistics.median(times) * 1e3


def phase_search(embs: np.ndarray, device) -> dict:
    from clipx_torch.search.engine import (IndexWriter, VectorIndex,
                                           read_index_vectors)
    from clipx_torch.store.kv import open_env

    n = embs.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        env = open_env(os.path.join(tmp, "vectors.lmdb"))
        db = env.open_db(b"fn_db")
        with env.begin(db=db, write=True) as txn:
            for i, e in enumerate(embs):
                txn.put(f"img{i:05d}.png".encode(), e.tobytes())
        with env.begin(db=db) as txn:
            back = np.stack([np.frombuffer(v, np.float32)
                             for _, v in txn.cursor()])
            check(txn.stat()["entries"] == n, "kv entry count")
        env.close()
        check(np.array_equal(back, embs), "kv store round trip")
        path = os.path.join(tmp, "images.index")
        writer = IndexWriter(path, n, embs.shape[1])
        writer.write(back)
        writer.close()
        stored = read_index_vectors(path)
        check(np.array_equal(stored, embs), "images.index round trip")

    gen = torch.Generator(device=device).manual_seed(SEED)
    corpus = torch.randn((CORPUS_ROWS, DIM), generator=gen, device=device)
    corpus /= torch.linalg.vector_norm(corpus, dim=1, keepdim=True)
    exact = VectorIndex(DIM, quantized=False, device=device)
    exact.add(corpus)
    exact.add(stored)
    # 8 encoded images and 8 perturbed corpus rows as queries
    picks = torch.randint(0, CORPUS_ROWS, (NQ // 2,), generator=gen,
                          device=device)
    noisy = corpus[picks] + 0.05 * torch.randn(
        (NQ // 2, DIM), generator=gen, device=device)
    del corpus
    queries = np.concatenate([stored[:NQ // 2], noisy.cpu().numpy()])
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    De, Ie, exact_ms = _search_p50(exact, queries, K)
    quant = exact
    quant.quantized = True
    Dq, Iq, quant_ms = _search_p50(quant, queries, K)

    total = CORPUS_ROWS + n
    check(Ie.shape == (NQ, K) and bool((Ie >= 0).all())
          and bool((Ie < total).all()) and bool(np.isfinite(De).all()),
          "exact search result shape/ids")
    check(bool((np.diff(De, axis=1) <= 0).all()), "exact scores not sorted")
    check(bool((Ie[NQ // 2:, 0] == picks.cpu().numpy()).all()),
          "a perturbed corpus row did not find itself first")
    same = (Iq == Ie).all(axis=1)
    # the near-duplicate exception: inside a cluster tighter than int8 noise
    # the order may differ; top-1 and scores within NEAR_DUP_ATOL may not
    exc_ok = ((Iq[:, 0] == Ie[:, 0])
              & (np.abs(Dq - De) <= NEAR_DUP_ATOL).all(axis=1))
    check(bool((same | exc_ok).all()),
          f"quant ids differ from exact beyond the near-duplicate "
          f"exception in rows {np.nonzero(~(same | exc_ok))[0].tolist()}")
    info = {"phase": "search", "rows": total, "dim": DIM, "k": K,
            "queries": NQ, "exact_p50_ms": exact_ms,
            "quant_p50_ms": quant_ms,
            "quant_rows_identical": int(same.sum()),
            "quant_rows_near_dup_exception": int((~same).sum()),
            "max_abs_score_diff": float(np.abs(Dq - De).max())}
    emit(info)
    return info


def phase_profile(enc, images: np.ndarray, encode_info: dict) -> dict:
    """Where a 128-image encode spends device time: torch.profiler's CUDA
    kernel totals over two batches, by kernel name. The card's busy share
    is that device time over the host's wall per batch without the
    profiler (timed here, and in phase encode), since the profiler slows
    the host; the share under the profiler is given beside it."""
    batch, reps, plain_reps = images[:BATCH], 2, 8
    enc.encode_images(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(plain_reps):
        enc.encode_images(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / plain_reps
    kernels, wall_prof = _profiled(lambda: enc.encode_images(batch), reps)
    busy = sum(ms for _, ms, _ in kernels)
    wall_encode = encode_info["seconds"] * 1e3 / (N_IMAGES // BATCH)
    info = {"phase": "profile", "batch": BATCH,
            "wall_ms_per_batch": wall,
            "wall_ms_per_batch_encode_phase": wall_encode,
            "wall_ms_per_batch_profiled": wall_prof,
            "profiler_host_overhead_ms": wall_prof - wall,
            "device_ms_per_batch": busy,
            "device_busy_share": busy / wall,
            "device_busy_share_encode_phase": busy / wall_encode,
            "device_busy_share_profiled": busy / wall_prof,
            "top_kernels": [{"name": name[:90], "ms": ms, "calls": n,
                             "share": ms / busy}
                            for name, ms, n in kernels[:12]]}
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase 6: the CLIs
# ---------------------------------------------------------------------------

def phase_cli(info_env: dict) -> dict:
    pkgs = info_env["host_packages"]
    if not (pkgs["PIL"] or pkgs["cv2"]):
        info = {"phase": "cli", "skipped": "neither PIL nor cv2 imports"}
        emit(info)
        return info
    env = dict(os.environ, PYTHONPATH=ROOT, CLIPX_NO_VIEWER="1")
    with tempfile.TemporaryDirectory() as tmp:
        photos = os.path.join(tmp, "photos") + os.sep
        work = os.path.join(tmp, "work")
        os.makedirs(photos)
        os.makedirs(work)
        rng = np.random.default_rng(SEED)
        names = ["a.jpg", "b.jpeg", "c.PNG", "d.png", "e.jpg", "f.png"]
        if pkgs["PIL"]:
            from PIL import Image

            for i, nm in enumerate(names):
                arr = rng.integers(0, 256, (240 + 8 * i, 320, 3), np.uint8)
                Image.fromarray(arr).save(photos + nm)
            backend = "PIL"
        else:
            import cv2

            for i, nm in enumerate(names):
                arr = rng.integers(0, 256, (240 + 8 * i, 320, 3), np.uint8)
                cv2.imwrite(photos + nm, arr)
            backend = "cv2"
        with open(photos + "broken.jpg", "wb") as f:
            f.write(b"not an image")
        decode = ["--decode-backend", "cv2" if pkgs["cv2"] else "pil"]
        t0 = time.perf_counter()
        build = subprocess.run(
            [sys.executable, "-m", "clipx_torch.cli.build_index",
             "--device", "cuda", *decode, photos], cwd=work, env=env,
            capture_output=True, text=True, timeout=600)
        build_s = time.perf_counter() - t0
        check(build.returncode == 0, f"build_index failed:\n{build.stderr}")
        out = build.stdout
        for want in (f"CLIPing {photos}...", "Preparing index for 6 "
                     "entries...", "Generating (6, 512) matrix...",
                     "Saving index...", "Done!"):
            check(want in out, f"build_index stdout lacks {want!r}")
        progress = out.split(f"CLIPing {photos}...")[1].split("Preparing")[0]
        check(progress.count(".") == 6 and progress.count("#") == 1,
              f"build_index progress {progress!r}")
        t0 = time.perf_counter()
        query = subprocess.run(
            [sys.executable, "-m", "clipx_torch.cli.query_index",
             "--device", "cuda"], cwd=work, env=env,
            input="a photo of a cat\ni 1\nq\n", capture_output=True,
            text=True, timeout=600)
        query_s = time.perf_counter() - t0
        check(query.returncode == 0, f"query_index failed:\n{query.stderr}")
        lines = query.stdout.splitlines()
        rows = [ln for ln in lines if len(ln.split()) == 3
                and ln.split()[1].isdigit() and ln.split()[2].startswith(
                    photos)]
        check(query.stdout.count("Search time:") == 2,
              "query_index: expected two searches")
        check("Similar to " + photos in query.stdout,
              "query_index: 'i 1' did not answer")
        # 6 images, rank 0 skipped: 5 rows for the text query, 5 for 'i 1'
        check(len(rows) == 10, f"query_index printed {len(rows)} rows")
    info = {"phase": "cli", "fixtures": backend, "build_s": build_s,
            "query_s": query_s, "result_rows": len(rows)}
    emit(info)
    return info


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "clipx_torch", "csrc")):
        print("chip_smoke: clipx_torch/ is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs one "
              "GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    from clipx_torch.ops import packed_sdpa as ps

    info = phase_env()
    results = phase_kernels(device)
    enc, setup_s = make_encoder(device)
    emit({"phase": "encoder_setup", "seconds": setup_s})
    images = np.random.default_rng(SEED).integers(
        0, 256, (N_IMAGES, 224, 224, 3), dtype=np.uint8)
    # the main path: counts from 0 just before it, read just after
    ps.reset_launches()
    encoded = phase_encode(enc, images)
    phase_text(enc)
    phase_search(encoded["embs"], device)
    launches = dict(ps.LAUNCHES)
    emit({"phase": "main_path_launches", "launches": launches})
    check(launches["fused_attn_block"] > 0 and launches["packed_sdpa"] > 0,
          "a kernel of the main path was never launched")
    phase_profile(enc, images, encoded["info"])
    del enc
    phase_cli(info)
    emit(kernels_line(results, launches))
    print(info["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
