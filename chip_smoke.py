"""Smoke run of the PyTorch/CUDA port (clipx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from clipx_torch/csrc with nvcc, then runs
these phases, printing one JSON line per phase:

1. env      — torch / CUDA / nvcc versions, the card's name and power
              limit, which optional host packages import.
2. kernels  — each kernel at the shapes the main path gives it, against its
              plain PyTorch version on the card (stated bf16 tolerance and
              an f32 plain run for the attention kernels, B5 and B7;
              bitwise for the PQ scan, packed_sdpa_qkv against packed_sdpa
              and B6's first-stage int8 codes, B6's output within 1e-2 of
              max|ref| and its hidden layer bitwise the retired mma.sync
              GEMM's, by a recorded sha256); CUDA-event medians of the
              kernel, the plain version and one PyTorch library call, and
              their device times from torch.profiler; for B1, B5, B6, B7
              and B9 the device time and TFLOP/s (TOP/s for B6) of each
              launch (LayerNorm, attention core, SDPA, row quantizer, each
              GEMM), and B1 at a ragged (5, 50, 768) too; the device ms of
              B6's and B7's two GEMMs, B9's out projection and B1's at
              every tile width, beside the wrappers' picks; the PQ scan
              swept bitwise over rows, halves, queries, LUT types and the
              extreme sums; the SDPA kernel (csrc/sdpa_sm90.cuh) swept over
              S, D, causal, odd and even B and its three layouts, each case
              against plain; the ptxas registers of the SDPA, PQ-scan and
              int8-GEMM kernels (no spill, no wgmma-serialisation warning).
3. encode   — the Encoder at ViT-B/32 full width (seeded random weights):
              1,024 seeded images in batches of 128, then one batch of 1;
              launch counts checked; a few images against the port's CPU f32
              encode of the same weights (cosine >= 0.99).
4. text     — encode_texts latency with the port's tokenizer.
5. search   — the phase-3 embeddings through the port's KV store and
              images.index writer and back; exact and int8-seg ("quant")
              search at 1,000,000 x 512 + those rows, k=50, 16 queries.
6. coded    — the same corpus as images.index plus images.index.codes for
              int8 and int4 (encode seconds, bytes), each loaded with
              the sidecar and codes-only, and bf16: search p50, recall@50
              and top-1 against phase 5's exact ids; then a pq capacity
              scan over 2^24 seeded random codes (one B11 launch at
              Q = 1, eight 2^21-row chunks at Q = 16).
              Beside it run, in threads: the pq tier's encode, phase ivf's
              residual pq build, phase cli and phase quality (in a process
              of its own); cli and quality end before it times its first
              search, the two encodes before phase coded_pq.
   coded_pq — (after phase resnet) the pq tier of phase coded, once its
              encode has ended: the same loads, searches and checks.
   parity   — the real-weight parity gate (clipx_torch/tools/
              parity_check.py). With $CLIPX_CHECKPOINT, the BPE merge table
              and the golden file present, its golden case on the card at
              cosine >= 0.999; without them (the line lists what is
              missing), its machinery at ViT-B/32 full width on seeded
              weights: the tree written as an .npz to a temporary
              directory, a golden file from phase encode's CPU f32 encoder,
              Encoder.create(checkpoint=) on the card against it (>= 0.99),
              the tree against the preset's; the six golden images as one
              batch (B1) and one at a time (B2), both counted; its seconds
              beside a 30 s budget.
7. profile  — torch.profiler over two 128-image encodes: device time by
              kernel name, and the card's busy share of the host's wall
              per batch without the profiler (and with it).
   preprocess — --preprocess device at ViT-B/32 with phase 3's weights:
              1,024 seeded 256 x 256 canvases in batches of 128 and one
              batch of 1 (B1, B2 counted), img/s beside phase 3's; a few
              against the CPU's f32 canvas path; the resize alone, card f32
              vs CPU f32, with its time and bound; a non-square batch
              raises.
   ivf      — --search-mode ivf (clipx_torch/search/ivf.py) on phase 5's
              corpus: k-means seconds on the card, twice (one layout
              digest); install seconds and, at nprobe 1, 32 and 100, search
              p50 at Q = 1 and 16, recall@50 and a Q = 1 profile for f32
              (quantized, and unquantized, whose nprobe-100 ids must be
              phase 5's exact ids), and int8, int4 and non-residual pq
              installed from phase 6's codes files; residual pq (the
              default) on the last 131,072 rows, built beside phases
              coded to resnet. B11 once per query and
              probed chunk, its device ms per search, pq_scan_scores_plain
              refused; B11 bitwise against plain on probed chunks, beside
              the flat scan's device ms.
   serve    — the port's HTTP service (clipx_torch/serve.py) at ViT-B/32
              on phase 5's corpus, in this process (clients in a process of
              their own), with phase 3's encoder and the attention and PQ
              plain versions refused: default flags (quant at 1M rows;
              warm-up seconds; /search_vector and /search?q= closed loop at
              1 and 16 clients against direct searches; /similar;
              /search_image and /encode_image of 1 (B2 only) and 8 (B1
              only), embeddings bitwise; /reload incremental and rebuild,
              the rebuild's allocator peak in corpora); --corpus-dtype pq
              booted from phase 6's pq codes (B11 once a search batch);
              CLIPX_SERVE_COALESCE=0 at 16 clients; --sharded on (one
              /search_vector answer equal to the default part's); a cold
              start without warm-up in a process of its own (first request
              of each family against the warm numbers, then SIGTERM).
   sharded  — corpus-sharded search and the dp encode (clipx_torch/
              parallel) on a "shard" mesh of cuda:0 listed 4 times (with
              more GPUs visible, f32 and pq again over all of them): each
              flat tier on phase search's corpus (f32, bf16, quant from the
              rows; int8, int4, pq from phase coded's payloads), p50, recall
              and ids against the single-device index (exact f32 and bf16
              identical), B11 once a shard; growth by a 1 % append against
              the fresh build; ShardedIVFIndex on phase ivf's layouts (f32
              at nprobe 32 and 100 against IVFIndex, residual pq from its
              stashed codes); ViT-B/32 over a "dp" mesh of cuda:0 twice on
              phase encode's images (B1 once a layer a share, against phase
              encode); one search over a single-rank NCCL process group;
              then B11 bitwise against plain on one shard's codes.
   int8     — --compute int8 at ViT-B/32: 1,024 images and a batch of 1
              with CLIPX_FUSED_MLP_INT8=on (fused_mlp_w8a8, on the K-major
              weight copies made at quantization: no per-call transpose)
              and without, against the CPU's f32 int8 encode;
              CLIPX_INT8_ATTN/PATCH
              (packed_sdpa_rows, packed_sdpa); ViT-L/14@336px int8 (no
              fused MLP there); a profile of one int8 batch.
   fused    — ViT-B/32 under CLIPX_FUSED_MLP=on (fused_mlp in both towers,
              text p50, device ms of one profiled 128-image batch) and
              CLIPX_PACKED_SDPA=sublayer (fused_attn_sublayer), 1,024
              images each, against the CPU.
8. long     — ViT-L/14@336px at full width (S = 577): 256 seeded 336 x 336
              images in batches of 128, then one batch of 1, checked
              against the port's CPU f32 encode; text p50 of its 768-wide
              tower; exact and quant search over 1,000,000 x 768 + those
              rows; the CLIPX_PACKED_SDPA=qkv and attn_impl="pallas"
              routes, clip_forward with "pallas" (the causal text tower
              too), torch.profiler over one 128-image encode, then
              ViT-B/16 (S = 197) and ViT-B/32 under =qkv and =rows, each
              call with its launch counts checked.
   siglip   — SigLIP so400m/14@384 at published widths and whole depth
              (seeded random weights; S = 729, head dim 72, the MAP head):
              256 seeded 384 x 384 frames through encode_images_async /
              finalize, two batches of 128 in flight, then one batch of 1,
              B8 (fused_sdpa_long at D = 72) once a layer a batch and no
              other kernel of the port, checked against the port's CPU f32
              encode; encode_texts refused (no SentencePiece model).
   resnet   — the ResNet towers at full width (seeded random weights):
              RN50 on 1,024 seeded 224 x 224 images in batches of 128 and
              one of 1 (img/s, no kernel of the port launched), against the
              CPU's f32 encode; a profile of one batch (device ms by kernel
              class, busy share); RN50's text p50; RN101, RN50x4, RN50x16
              and RN50x64 on 8 images each (batch ms), against the CPU on 2.
   quality  — (beside phase coded, in a process of its own: python3
              chip_smoke.py --phase quality, its launches counted there)
              the port's quality tool (clipx_torch/tools/eval_quality.py)
              on tests/test_quality_gate.py's corpus (10,000 x 512, k = 50)
              held to that test's floors, and its drift leg over 12 PNGs
              that build_index indexed at ViT-B/32 on the card (cv2 >=
              0.9999, int8 compute >= 0.99, PIL reported).
   train    — contrastive training (clipx_torch/train.py) at ViT-B/32 full
              width, seeded init, f32 with TF32 off: 3 steps of one batch of
              8 seeded pairs on the card against the CPU (loss, accuracy,
              grad norm, every parameter's update; stated tolerances);
              CUDA-event step ms, the allocator's peak and a profile of one
              step (device ms by kernel class, busy share) at batch 64;
              --remat on the same 10 batches (loss within 1e-6, peak
              lower); python -m clipx_torch.cli.train on 256 seeded JPEG +
              caption pairs at its defaults, SIGTERM after its step-20 line
              (exit 0, checkpoint), then its main() with --resume for 5
              more steps (the optimizer's count follows), the params.npz
              loaded into the Encoder; RN50: 10 timed steps at batch 64 and
              one card-vs-CPU step at batch 4.
   tp       — tensor parallelism (clipx_torch/parallel/tensor.py) at
              ViT-B/32 full width over {"dp": 2, "tp": 2} of cuda:0 listed
              4 times: the TP Encoder (attn_impl "pallas" asked, "plain"
              taken) on phase encode's 1,024 images at batch 128, cosine
              >= 0.99 against phase encode's embeddings and the CPU's f32
              encode, img/s beside phase encode's; the dp x tp step in f32
              with TF32 off: 3 steps of phase train's batch of 8 against
              phase train's CPU steps (its tolerances, every replica
              bitwise), 10 timed steps of its batches of 64 (median ms and
              allocator peak beside the single-device step's) and --remat
              on 3 of them
              (losses within 1e-6); 2 steps over a one-rank NCCL group
              against the in-process steps; with more GPUs visible, the
              encode and the step again over {"dp": n / 2, "tp": 2}.
   tools    — the capacity and maintenance tools (clipx_torch/tools/):
              make_synth_index at 1,000,000 x 512 and build_codes_direct at
              120,000 x 64 in processes of their own while find_dupes
              searches 200,000 rows with 500 planted groups (found =
              planted) and kv_tool stats, verifies and compacts phase
              search's store; kv_tool drop-f32 refused (no codes file);
              load_timing int8 cold, then warm with --query; load_timing pq
              --query on phase coded's pq deployment (B11), then drop-f32 on
              it; the direct build booted codes-only (self-match at rank 0
              and recall@50 over 1,024 queries in
              tests/test_direct_build.py's bands).
9. cli      — (beside phase coded) build_index and a scripted
              query_index REPL at ViT-B/32 on a
              few fixture images, then the same with --corpus-dtype pq,
              with --corpus-dtype pq --search-mode ivf (and a restart that
              loads its codes and .ivf),
              with --compute int8 (CLIPX_FUSED_MLP_INT8=on), then both at
              --model ViT-L/14@336px, with --preprocess device, and at
              --model RN50, and both commands with --sharded on (the rows
              of the default leg; the indexer's data-parallel line), each
              build's [stats] rates read from stderr;
              all seven legs at once, each in a work dir of its own (only
              when PIL or cv2 imports).

They run in this order: env, kernels, encode, text, search, coded (cli
and quality beside it), profile, preprocess, int8, fused, long, resnet,
coded_pq, parity, ivf, serve, sharded, train, tp, tools. Phases 3-6 are
the main path of ViT-B/32 (which must launch none of the opt-in kernels
B5-B7), phase coded_pq the pq tier's (B11 only), phase parity the parity
gate's (B1 and B2 only), phase preprocess the canvas path (B1 and B2
only),
phase ivf the IVF path (B11 only), phase serve the HTTP service's path
(B1, B2 and B11 only; each of its parts counted on its own), phase sharded
the sharded path (B1 and B11 only), phases int8
and fused its opt-in routes, phase 8 the long towers' path, phase resnet
the ResNet towers' (no kernel), phase quality the gate's (B1, B2 and B11),
phase train training's (no kernel: clipx's train step reaches none),
phase tp the tensor-parallel paths' (no kernel: clipx's TP encode and
sharded step take plain attention) and phase tools the tools' (B11 only):
every launch count is set to 0 just before each and read just after it
(phase quality's in its own process), and every kernel must have been
launched on one of them. The host's OPQ training (the pq tier's encode,
phase ivf's residual build) takes minutes and times nothing on the card,
so it runs in two threads beside the phases from coded to resnet, and the
phases that start processes of their own (cli, quality) beside phase
coded's int8 and int4 encodes, with numpy's BLAS on one thread a process
(OPENBLAS_NUM_THREADS, unless set). Then one
line
gives each phase's seconds (cli's and quality's: each one's own wall), one lists every kernel ({"kernels": [...]})
with the sum of those counts, and one the card's name and power limit;
the last line is
{"ok": true, "device": {...}}. Any failed check raises, so the run exits
non-zero and prints no result line; so does a machine without a GPU, or a
directory without the clipx_torch package beside this script.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

# numpy's OpenBLAS keeps one thread a core, and they spin between calls.
# The host work that runs beside the phases (two OPQ trainings in threads,
# the quality and CLI processes) then starves itself instead of
# overlapping, while the OPQ training, small GEMMs and element-wise numpy,
# runs as fast on one BLAS thread as on eight. So unless the caller chose,
# this process and the ones it starts run BLAS on one thread each (before
# numpy is imported: OpenBLAS reads it once)
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (dense): bf16 tensor cores, f32 outside
# them, HBM bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
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


_EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    """One JSON line on stdout, whole even when a thread beside the phases
    prints too."""
    line = (obj if isinstance(obj, str) else json.dumps(obj)) + "\n"
    with _EMIT_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


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


# profiler sessions that saw no device kernel (or, in _per_launch, lost
# some of a call's kernels) and were repeated
EMPTY_PROFILES = []
PROFILE_TRIES = 5
# names of kernels whose sources are gone: the FMA short SDPA and the
# mma.sync long SDPA, both replaced by csrc/sdpa_sm90.cuh; the mma.sync
# int8 GEMM (gemm_s8_kernel), replaced by csrc/gemm_s8_sm90.cuh; the
# lane-packed PQ scan (pq_scan_kernel<QW>), replaced by the one-hot scan
RETIRED_KERNELS = ("short_sdpa", "long_sdpa_kernel", "gemm_s8_kernel",
                   "pq_scan_kernel<")
# torch.cuda._sleep's kernel, launched first in every profiler session and
# left out of its results: on the H100 every session of one run left out
# one launch of the first kernel that fn launches (B9's attention step,
# 19 of 20 calls in each of PROFILE_TRIES sessions), as one card test's
# session left out the first of B6's two row quantizers
PRIMER_KERNEL = "spin_kernel"


def _profiled(fn, iters: int, host_ops: bool = True):
    """torch.profiler over iters calls of fn: (CUDA time by kernel name in
    ms per call, calls per call of fn, host wall in ms per call). A session
    that records no device kernel at all is repeated, up to PROFILE_TRIES
    sessions, and counted in EMPTY_PROFILES: on the H100 one such session
    came back empty for a kernel that the same code had profiled in earlier
    runs. A kernel of a retired source (RETIRED_KERNELS) fails the run.
    Each session first launches a throwaway kernel (PRIMER_KERNEL), which
    the results leave out. With ``host_ops=False`` the session records CUDA activity only: a dp x
    tp step launches tens of thousands of host ops, whose records make a
    CPU-side profile take tens of seconds and inflate the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    for attempt in range(PROFILE_TRIES):
        with profile(activities=activities) as prof:
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                           e.count / iters) for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0
                          and PRIMER_KERNEL not in e.key),
                         key=lambda r: -r[1])
        if kernels:
            break
        EMPTY_PROFILES.append(getattr(fn, "__qualname__", str(fn)))
    retired = [name[:100] for name, _, _ in kernels
               if any(r in name for r in RETIRED_KERNELS)]
    check(not retired, f"a retired kernel was launched: {retired}")
    return kernels, wall * 1e3 / iters


def device_ms(fn, iters: int = 20, required: bool = True):
    """Device time of one call of fn, in ms: the sum of the CUDA kernels
    it launches, read by torch.profiler (mean of iters calls). Unlike
    cuda_ms it leaves out the host's work between launches. Where the
    profiler sees no kernel of fn (some library backends launch outside
    its view), a required time fails the run and any other is None."""
    fn()
    torch.cuda.synchronize()
    kernels, _ = _profiled(fn, iters)
    ms = sum(t for _, t, _ in kernels)
    check(ms > 0 or not required, "torch.profiler saw no device time")
    return ms if ms > 0 else None


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

# readable names of the mangled kernel instances in nvcc's log
_PTXAS_NAMES = (
    (r"gemm_sm90_kernelILi(\d+)ELi(\d+)E", "gemm_sm90_kernel<{}, {}>"),
    (r"gemm_s8_sm90_kernelILi(\d+)ELi(\d+)E", "gemm_s8_sm90_kernel<{}, {}>"),
    (r"sdpa_sm90_kernelILi(\d+)E", "sdpa_sm90_kernel<{}>"),
    (r"pq_scan_onehot_kernelILi(\d+)E", "pq_scan_onehot_kernel<{}>"),
    (r"quant_rows_kernelI(13__nv_bfloat16|f)E", "quant_rows_kernel<{}>"))


def ptxas_table(log: str) -> dict:
    """{kernel: "registers; stack and spills"} from nvcc's -Xptxas -v log,
    with template instances named as in the source, such as
    gemm_sm90_kernel<BN, epilogue>."""
    table, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            for pattern, form in _PTXAS_NAMES:
                g = re.search(pattern, entry)
                if g:
                    entry = form.format(*(
                        "bf16" if a == "13__nv_bfloat16" else
                        "float" if a == "f" else a for a in g.groups()))
                    break
            table[entry] = ""
        elif entry and ("registers" in line or "spill" in line):
            table[entry] = "; ".join(
                filter(None, (table[entry], line.split(":", 1)[-1].strip())))
    return table


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
            "library_device_ms": device_ms(library, required=False)}


def phase_kernels(device) -> dict:
    import torch.nn.functional as F

    from clipx_torch.ops import _build
    from clipx_torch.ops import packed_sdpa as ps

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_table(log) for name, log in logs.items()}
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
        "launches": _per_launch(lambda: ps.fused_attn_block(*args, heads=h),
                                _sm90_flops(b, s, w, h)),
    }
    check(ok_p, f"fused_attn_block vs plain: max err {err_p}")
    check(ok_k and ok_t, f"fused_attn_block vs f32: {err_k}, {err_t}")
    # B1 at a ragged shape: an odd batch, whose last block has one batch
    # row, and whose last row's x box runs past the end (TMA's zero fill)
    xr = _bf16(gen, (5, s, w), 1.0, device)
    ragged = _attn_check(
        "fused_attn_block (5, 50, 768)",
        lambda: ps.fused_attn_block(xr, *args[1:], heads=h),
        lambda: ps.fused_attn_block_plain(xr, *args[1:], heads=h),
        lambda: ps.fused_attn_block_plain(*_f32(xr, *args[1:]), heads=h))
    results["fused_attn_block"]["ragged"] = ragged

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

    sweep = _sdpa_sweep(device, gen)
    results.update(_kernels_long(device, gen))
    results["pq_scan_scores"] = _kernel_b11(device)
    results.update(_kernels_mlp(device, gen))
    tiles = _tile_sweep(device, gen)
    emit({"phase": "kernels", "build_s": build_s, "ptxas": ptxas,
          "ptxas_redesigned": kernels_ptxas(),
          "tile_widths": tiles, "sdpa_sweep": sweep,
          "tolerance": {"vs_plain": [ATOL_PLAIN, RTOL_PLAIN],
                        "vs_f32": [ATOL_F32, RTOL_F32],
                        "packed_sdpa_qkv": "bitwise vs packed_sdpa",
                        "sdpa": "packed_sdpa = packed_sdpa_rows = "
                        "packed_sdpa_qkv = fused_sdpa_long bitwise at "
                        "S <= 64, D = 64",
                        "pq_scan_scores": "bitwise",
                        "fused_mlp_w8a8": "first-stage codes and scales "
                        f"bitwise; output within {W8A8_REL} x max|ref|; "
                        "hidden layer bitwise the mma.sync GEMM's "
                        "(B6_H_SHA256)"},
          "results": results})
    return results


def _attn_check(name, kernel, plain, plain_f32, library=None, *, flops=0,
                nbytes=0) -> dict:
    """One bf16 kernel (attention, or B5's and B7's GEMMs) against its
    plain version on the same bf16 inputs (ATOL_PLAIN/RTOL_PLAIN) and
    against an f32 plain run on the upcast inputs (ATOL_F32/RTOL_F32); with
    a library yardstick, also the times and the bound of this shape."""
    out = kernel()
    ref = plain()
    truth = plain_f32()
    torch.cuda.synchronize()
    ok_p, err_p = _close(out, ref, ATOL_PLAIN, RTOL_PLAIN)
    ok_k, err_k = _close(out, truth, ATOL_F32, RTOL_F32)
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite output")
    check(ok_p, f"{name} vs plain: max err {err_p}")
    check(ok_k, f"{name} vs f32: max err {err_k}")
    info = {"shape": list(out.shape), "max_abs_err": err_p,
            "max_abs_err_vs_f32": err_k}
    del out, ref, truth
    if library is not None:
        bms, by = bound(flops, nbytes)
        info.update(**_times(kernel, plain, library), bound_ms=bms,
                    bound_by=by, flops=flops, bytes=nbytes)
    torch.cuda.empty_cache()
    return info


def _f32(*ts):
    return [t.float() for t in ts]


# the kernels one call launches, by role and a pattern of their names, for
# each kernel whose launches are split: B1 and B5, B7, B9. A
# gemm_sm90_kernel<BN, epilogue> instance carries its epilogue: 0 bias, 1
# residual, 2 QuickGELU, 3 erf GELU (csrc/gemm_sm90.cuh's Epilogue)
_GEMM_SM90 = r"gemm_sm90_kernel<(\d+), "
_GEMM_S8 = r"gemm_s8_sm90_kernel<(\d+), "
SM90_ROLES = {
    "attn_block": (("layernorm", r"layernorm_rows"),
                   ("attn_core", r"attn_core_sm90"),
                   ("out_gemm", _GEMM_SM90 + r"[01]>")),
    "fused_mlp": (("up_gemm", _GEMM_SM90 + r"[23]>"),
                  ("down_gemm", _GEMM_SM90 + r"0>")),
    "fused_sdpa_long_qkv": (("attention", r"sdpa_sm90_kernel"),
                            ("out_gemm", _GEMM_SM90 + r"0>")),
    # B6: gemm_s8_sm90_kernel<BN, epilogue, out>, 0 bf16 out, 1 QuickGELU, 2
    # erf GELU (csrc/gemm_s8_sm90.cuh's GemmS8Epilogue)
    "fused_mlp_w8a8": (("quant_x", r"quant_rows_kernel<__nv_bfloat16>"),
                       ("up_gemm", _GEMM_S8 + r"[12], "),
                       ("quant_h", r"quant_rows_kernel<float>"),
                       ("down_gemm", _GEMM_S8 + r"0, ")),
}


def _sm90_flops(b, s, w, h) -> dict:
    """The operations of B1's two launches at (B, S, W) / h heads: the qkv
    projection and the attention (the useful rows; the kernel pads each
    batch row to 64, counted in attn_core_padded), and the out projection."""
    rows_pad = 2 * ((b + 1) // 2) * 64
    return {"attn_core": 2 * b * s * w * 3 * w + _attn_flops(b, h, s, 64),
            "attn_core_padded": (2 * rows_pad * w * 3 * w
                                 + 4 * rows_pad * h * 64 * 64),
            "out_gemm": 2 * b * s * w * w}


def _per_launch(fn, flops: dict, roles: str = "attn_block",
                required=("attn_core", "out_gemm"), iters: int = 20) -> dict:
    """Device ms of each kernel that one call of fn launches (torch.profiler,
    mean of iters calls), by role (``SM90_ROLES[roles]``), with the
    achieved TFLOP/s of the useful operations in ``flops`` (and of the
    padded ones where given), and each GEMM's tile width. Fails if the call
    launches any other kernel, misses a role in ``required``, or launches a
    role's kernel more than once. A session that recorded a role's kernel
    in fewer than every call (the profiler lost events: seen on the H100)
    is repeated like an empty one, up to PROFILE_TRIES sessions."""
    fn()
    torch.cuda.synchronize()
    table = SM90_ROLES[roles]
    for attempt in range(PROFILE_TRIES):
        kernels, _ = _profiled(fn, iters)
        found = [sum(n for name, _, n in kernels if re.search(pattern, name))
                 for _, pattern in table]
        if all(n == 0 or n > 1 - 1e-6 for n in found):
            break
        EMPTY_PROFILES.append(f"{roles}: partial session")
    out = {}
    for role, pattern in table:
        hits = [(name, t, n) for name, t, n in kernels
                if re.search(pattern, name)]
        if not hits:
            continue
        out[role] = {"device_ms": sum(t for _, t, _ in hits),
                     "calls": sum(n for _, _, n in hits),
                     "kernels": sorted({name[:100] for name, _, _ in hits})}
        bn = re.search(_GEMM_SM90, hits[0][0]) or re.search(_GEMM_S8,
                                                             hits[0][0])
        if bn:
            out[role]["tile_n"] = int(bn.group(1))
        if role in flops:
            out[role]["tflops"] = flops[role] / out[role]["device_ms"] / 1e9
        if role + "_padded" in flops:
            out[role]["tflops_padded"] = (flops[role + "_padded"]
                                          / out[role]["device_ms"] / 1e9)
    others = [name[:100] for name, _, _ in kernels
              if not any(re.search(p, name) for _, p in table)]
    check(not others and all(r in out for r in required),
          f"{roles}: launched other kernels than {[r for r, _ in table]}: "
          f"{others}, or missed one of {required}: {sorted(out)}")
    check(all(abs(r["calls"] - 1) < 1e-6 for r in out.values()),
          f"{roles}: a role launched more than once a call: {out}")
    return out


def _sdpa_lib(q, k, v, heads, causal=False):
    """F.scaled_dot_product_attention on (B, S, H*D) views: the library
    yardstick of the long kernels (never called by the port)."""
    import torch.nn.functional as F

    b, s, w = q.shape

    def split(t):
        return t.view(b, s, heads, w // heads).transpose(1, 2)

    return F.scaled_dot_product_attention(split(q), split(k), split(v),
                                          is_causal=causal).transpose(1, 2)


def _attn_flops(b, h, s, d, causal=False):
    """QK^T and P @ V over the (row, key) pairs the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * h * pairs * d


def _kernels_long(device, gen) -> dict:
    """B8 fused_sdpa_long, B9 fused_sdpa_long_qkv, B10 flash_attention and
    B4 packed_sdpa_qkv at the long towers' and ViT-B/32's shapes."""
    from clipx_torch.ops import flash_attention as fa
    from clipx_torch.ops import packed_sdpa as ps

    res = {}
    # B8 at ViT-L/14@336px (the main shape), ViT-B/16 and SigLIP
    # so400m/14@384 (D = 72), all at the indexing batch, and causal at the
    # text tower's (4, 77, 768)
    cases = {}
    for tag, (b, s, w, h, causal) in {
            "vit_l14_336": (128, 577, 1024, 16, False),
            "vit_b16": (128, 197, 768, 12, False),
            "so400m": (128, 729, 1152, 16, False),
            "causal_text": (4, 77, 768, 12, True)}.items():
        q, k, v = (_bf16(gen, (b, s, w), 1.0, device) for _ in range(3))
        cases[tag] = _attn_check(
            f"fused_sdpa_long {tag}",
            lambda: ps.fused_sdpa_long(q, k, v, heads=h, causal=causal),
            lambda: ps.fused_sdpa_long_plain(q, k, v, heads=h, causal=causal),
            lambda: ps.fused_sdpa_long_plain(*_f32(q, k, v), heads=h,
                                             causal=causal),
            lambda: _sdpa_lib(q, k, v, h, causal),
            flops=_attn_flops(b, h, s, w // h, causal),
            nbytes=4 * b * s * w * 2)
        del q, k, v
    res["fused_sdpa_long"] = dict(cases["vit_l14_336"], cases=cases)

    # B9 at ViT-L/14@336px: attention + out projection (+ bias)
    b, s, w, h = 128, 577, 1024, 16
    qkv = _bf16(gen, (b, s, 3 * w), 1.0, device)
    wo = _bf16(gen, (w, w), 0.03, device)
    bo = (torch.randn(w, generator=gen) * 0.01).to(device)
    bo16 = bo.to(torch.bfloat16)

    def lib_b9():
        o = _sdpa_lib(qkv[..., :w], qkv[..., w:2 * w], qkv[..., 2 * w:], h)
        return torch.addmm(bo16, o.reshape(b * s, w), wo)

    res["fused_sdpa_long_qkv"] = _attn_check(
        "fused_sdpa_long_qkv",
        lambda: ps.fused_sdpa_long_qkv(qkv, wo, bo, heads=h),
        lambda: ps.fused_sdpa_long_qkv_plain(qkv, wo, bo, heads=h),
        lambda: ps.fused_sdpa_long_qkv_plain(*_f32(qkv, wo), bo, heads=h),
        lib_b9, flops=_attn_flops(b, h, s, w // h) + 2 * b * s * w * w,
        nbytes=b * s * 3 * w * 2 + w * w * 2 + w * 4 + b * s * w * 2)
    res["fused_sdpa_long_qkv"]["launches"] = _per_launch(
        lambda: ps.fused_sdpa_long_qkv(qkv, wo, bo, heads=h),
        {"attention": _attn_flops(b, h, s, w // h),
         "out_gemm": 2 * b * s * w * w},
        roles="fused_sdpa_long_qkv", required=("attention", "out_gemm"))
    del qkv, wo, bo, bo16

    # B10 on (B, H, S, D): ViT-L/14@336px's heads (the main shape), the
    # causal text tower's, and D = 32
    import torch.nn.functional as F

    cases = {}
    for tag, (shape, causal) in {
            "vit_l14_336": ((128, 16, 577, 64), False),
            "causal_text": ((4, 12, 77, 64), True),
            "d32_causal": ((16, 8, 257, 32), True)}.items():
        q, k, v = (_bf16(gen, shape, 1.0, device) for _ in range(3))
        bb, hh, ss, dd = shape
        cases[tag] = _attn_check(
            f"flash_attention {tag}",
            lambda: fa.flash_attention(q, k, v, causal=causal),
            lambda: fa.flash_attention_plain(q, k, v, causal=causal),
            lambda: fa.flash_attention_plain(*_f32(q, k, v), causal=causal),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal),
            flops=_attn_flops(bb, hh, ss, dd, causal),
            nbytes=4 * bb * hh * ss * dd * 2)
        del q, k, v
    res["flash_attention"] = dict(cases["vit_l14_336"], cases=cases)

    # B4 at ViT-B/32's indexing batch: bitwise equal to B2 on the slices
    b, s, w, h = 128, 50, 768, VIT_B32_HEADS
    qkv = _bf16(gen, (b, s, 3 * w), 1.0, device)
    q, k, v = (qkv[..., i * w:(i + 1) * w].contiguous() for i in range(3))
    check(torch.equal(ps.packed_sdpa_qkv(qkv, heads=h),
                      ps.packed_sdpa(q, k, v, heads=h)),
          "packed_sdpa_qkv differs from packed_sdpa on the same q, k, v")
    res["packed_sdpa_qkv"] = dict(_attn_check(
        "packed_sdpa_qkv",
        lambda: ps.packed_sdpa_qkv(qkv, heads=h),
        lambda: ps.packed_sdpa_qkv_plain(qkv, heads=h),
        lambda: ps.packed_sdpa_qkv_plain(qkv.float(), heads=h),
        lambda: _sdpa_lib(q, k, v, h),
        flops=_attn_flops(b, h, s, w // h), nbytes=4 * b * s * w * 2),
        equal_to_packed_sdpa=True)
    del qkv, q, k, v
    torch.cuda.empty_cache()
    return res


# The SDPA kernel's sweep: S of one key tile and its edges, of several, and
# of the long towers (77 the text tower's, 197 ViT-B/16's, 257 ViT-L/14's,
# 577 ViT-L/14@336px's, 729 SigLIP so400m/14@384's); causal at the S in
# SWEEP_CAUSAL too
SWEEP_S = (1, 50, 63, 64, 65, 77, 127, 128, 129, 197, 257, 577, 729)
SWEEP_CAUSAL = (1, 65, 77, 129, 257)
SWEEP_HEADS = 4


def _sdpa_sweep(device, gen) -> dict:
    """csrc/sdpa_sm90.cuh over SWEEP_S x D in LONG_HEAD_DIMS x causal, batch
    3 and 2 in turn, in each layout its wrappers give it: B8's (B, S, H*D),
    the packed (B, S, 3W) projection of B4 and B9 (through B4's launcher,
    which takes any S and D) and B10's (B, H, S, D); every case against its
    plain version (ATOL_PLAIN) and an f32 plain run (ATOL_F32). Then the
    bitwise rules of the one-tile path: packed_sdpa = packed_sdpa_rows =
    packed_sdpa_qkv = fused_sdpa_long at S <= 64, D = 64."""
    from clipx_torch.ops import flash_attention as fa
    from clipx_torch.ops import packed_sdpa as ps

    h = SWEEP_HEADS
    worst, n = {}, 0
    for d in ps.LONG_HEAD_DIMS:
        w = h * d
        for s in SWEEP_S:
            for causal in (False, True) if s in SWEEP_CAUSAL else (False,):
                b = 3 - n % 2
                n += 1
                qkv = _bf16(gen, (b, s, 3 * w), 1.0, device)
                q, k, v = (qkv[..., i * w:(i + 1) * w].contiguous()
                           for i in range(3))
                bhsd = [t.view(b, s, h, d).transpose(1, 2).contiguous()
                        for t in (q, k, v)]
                cases = {
                    "bshd": (
                        lambda: ps.fused_sdpa_long(q, k, v, heads=h,
                                                   causal=causal),
                        lambda: ps.sdpa_plain(q, k, v, heads=h, causal=causal),
                        lambda: ps.sdpa_plain(*_f32(q, k, v), heads=h,
                                              causal=causal)),
                    "packed": (
                        lambda: ps._launch_sdpa_qkv(qkv, h, causal),
                        lambda: ps.sdpa_plain(q, k, v, heads=h, causal=causal),
                        lambda: ps.sdpa_plain(*_f32(q, k, v), heads=h,
                                              causal=causal)),
                    "bhsd": (
                        lambda: fa.flash_attention(*bhsd, causal=causal),
                        lambda: fa.flash_attention_plain(*bhsd, causal=causal),
                        lambda: fa.flash_attention_plain(*_f32(*bhsd),
                                                         causal=causal))}
                for layout, fns in cases.items():
                    info = _attn_check(f"sdpa sweep {layout} B={b} S={s} "
                                       f"D={d} causal={causal}", *fns)
                    r = worst.setdefault(layout, {"max_abs_err": 0.0,
                                                  "max_abs_err_vs_f32": 0.0})
                    for key in r:
                        r[key] = max(r[key], info[key])
                del qkv, q, k, v, bhsd
    equal = {}
    w, h = 768, VIT_B32_HEADS
    for b, s in ((2, 50), (128, 50), (2, 64), (2, 1)):
        qkv = _bf16(gen, (b, s, 3 * w), 1.0, device)
        q, k, v = (qkv[..., i * w:(i + 1) * w].contiguous() for i in range(3))
        ref = ps.packed_sdpa(q, k, v, heads=h)
        same = [torch.equal(ref, ps.packed_sdpa_rows(q, k, v, heads=h)),
                torch.equal(ref, ps.packed_sdpa_qkv(qkv, heads=h)),
                torch.equal(ref, ps.fused_sdpa_long(q, k, v, heads=h))]
        check(all(same), f"SDPA at ({b}, {s}, {w}): packed_sdpa_rows, "
              f"packed_sdpa_qkv, fused_sdpa_long equal packed_sdpa: {same}")
        equal[f"{b}x{s}"] = True
    torch.cuda.empty_cache()
    return {"cases": n * len(cases), "heads": SWEEP_HEADS, "S": SWEEP_S,
            "causal_S": SWEEP_CAUSAL, "head_dims": ps.LONG_HEAD_DIMS,
            "worst": worst, "bitwise_equal": equal}


# the ptxas warnings that mean a kernel lost performance: setmaxnreg
# ignored (C7508), every wgmma serialised (C7514, C7515, C7518)
PTXAS_WARNINGS = ("C7508", "C7514", "C7515", "C7518")
# the instances each source's ptxas log must name: B8-B10's SDPA kernel
# (one a head dim), B11's scan (one or two n8 query blocks), B6's int8 GEMM
# (three tile widths x three epilogues) and its row quantizer
PTXAS_KERNELS = {"sdpa": (r"sdpa_sm90_kernel<", 4),
                 "pq_scan": (r"pq_scan_onehot_kernel<", 2),
                 "mlp": (r"gemm_s8_sm90_kernel<|quant_rows_kernel<", 11)}


def kernels_ptxas() -> dict:
    """{source: {kernel: ptxas -v line}} for the redesigned kernels of
    csrc/sdpa.cu, pq_scan.cu and mlp.cu, from their build logs; fails if an
    instance is missing, spills, or the log has a PTXAS_WARNINGS code."""
    from clipx_torch.ops import _build

    out = {}
    for src, (pattern, count) in PTXAS_KERNELS.items():
        with open(os.path.join(_build.BUILD_DIR, f"lib{src}.log")) as f:
            log = f.read()
        table = {k: v for k, v in ptxas_table(log).items()
                 if re.match(pattern, k)}
        check(len(table) == count,
              f"csrc/{src}.cu's ptxas log names {sorted(table)}")
        check(all("0 bytes spill stores" in v for v in table.values()),
              f"csrc/{src}.cu: a kernel spills: {table}")
        warned = [w for w in PTXAS_WARNINGS if w in log]
        check(not warned, f"csrc/{src}.cu: ptxas warned {warned}")
        out[src] = table
    return out


# B11 at the path's shapes: the 1,001,024-row corpus pads to a 2^20-row
# bucket; D = 512 gives M = 256 subspaces at dsub 2 (128 code bytes a row)
# and M = 128 at dsub 4 (64 bytes); a search sends Q <= 16 queries
PQ_ROWS = 1 << 20


# B11's bitwise sweep: row counts around the 64-row warp tile and the
# ragged corpus, halves that are and are not multiples of the kernel's
# 8-byte loads (up to D = 1024 at dsub 2), 1 to 16 queries (one and two n8
# blocks), int8 and integer bf16 LUTs; the extreme sums (all-0 and all-15
# nibbles against +-127 LUTs) at the big row count
PQ_SWEEP_ROWS = (1, 63, 64, 65)
PQ_BIG_ROWS = 1_000_037
PQ_SWEEP_HALVES = (8, 24, 64, 128, 256)
PQ_SWEEP_Q = (1, 3, 8, 9, 16)


def _pq_sweep(pqs, codes, lut, device) -> dict:
    """Every case of B11's sweep against pq_scan_scores_plain, bitwise."""
    cases = 0

    def same(p, t, what):
        out = pqs.pq_scan_scores(p, t)
        ref = pqs.pq_scan_scores_plain(p, t)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"pq_scan_scores {what} differs from "
              f"plain: max err {float((out - ref).abs().max())}")
        return out

    for half in PQ_SWEEP_HALVES:
        for n in PQ_SWEEP_ROWS + (PQ_BIG_ROWS,):
            p = codes(n, half)
            for q in PQ_SWEEP_Q:
                for dt in (torch.int8, torch.bfloat16):
                    if n == PQ_BIG_ROWS and dt == torch.bfloat16 and q != 16:
                        continue
                    same(p, lut(half, q).to(dt), (n, half, q, str(dt)))
                    cases += 1
        for byte, nibble in ((0, 0), (-1, 15)):
            p = torch.full((PQ_BIG_ROWS, half), byte, dtype=torch.int8,
                           device=device)
            for v in (127, -127):
                t = torch.full((half * 32, 16), v, dtype=torch.int8,
                               device=device)
                out = same(p, t, ("extreme", half, nibble, v))
                check(bool((out == v * 2 * half).all()),
                      f"pq_scan_scores extreme sum {half, nibble, v}")
                cases += 1
        del p
    return {"cases": cases, "rows": list(PQ_SWEEP_ROWS) + [PQ_BIG_ROWS],
            "halves": list(PQ_SWEEP_HALVES), "queries": list(PQ_SWEEP_Q),
            "all_bitwise": True}


def _kernel_b11(device) -> dict:
    """pq_scan_scores against its plain version, BITWISE (integer sums), at
    the flat pq search's shapes, (2^20, 128) codes x a (4096, 16) int8 LUT,
    the same with a bf16 LUT, (2^20, 64) at Q = 1 (dsub 4), and over
    _pq_sweep's cases. Times at the first shape, and device times at Q = 1
    (the REPL's single query); the library yardstick is torch._int_mm of a
    prebuilt (N, 4096) int8 one-hot by the LUT (the port never calls it)."""
    from clipx_torch.ops import pq_scan as pqs

    gen = torch.Generator(device=device).manual_seed(SEED)

    def codes(n, half):
        return torch.randint(-128, 128, (n, half), generator=gen,
                             dtype=torch.int8, device=device)

    def lut(half, q):
        return torch.randint(-127, 128, (half * 32, q), generator=gen,
                             dtype=torch.int8, device=device)

    cases = {}
    for name, (n, half, q, dt) in {
            "dsub2_q16": (PQ_ROWS, 128, 16, torch.int8),
            "dsub2_q16_bf16_lut": (PQ_ROWS, 128, 16, torch.bfloat16),
            "dsub4_q1": (PQ_ROWS, 64, 1, torch.int8)}.items():
        p, t = codes(n, half), lut(half, q).to(dt)
        out = pqs.pq_scan_scores(p, t)
        ref = pqs.pq_scan_scores_plain(p, t)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.equal(out, ref),
              f"pq_scan_scores {name} differs from plain: max err {err}")
        cases[name] = {"shape": [n, half, q], "max_abs_err": err}
        if q == 1:
            cases[name]["device_ms"] = device_ms(
                lambda: pqs.pq_scan_scores(p, t))
        del p, t, out, ref
    sweep = _pq_sweep(pqs, codes, lut, device)
    p, t = codes(PQ_ROWS, 128), lut(128, 1)
    cases["dsub2_q1"] = {"shape": [PQ_ROWS, 128, 1], "device_ms": device_ms(
        lambda: pqs.pq_scan_scores(p, t))}
    del p, t

    n, half, q = PQ_ROWS, 128, 16
    p, t = codes(n, half), lut(half, q)
    onehot = (pqs.unpack_codes4(p)[:, :, None] == torch.arange(
        16, dtype=torch.uint8, device=device)).to(torch.int8).reshape(n, -1)
    check(torch.equal(torch._int_mm(onehot, t).float().T,
                      pqs.pq_scan_scores(p, t)),
          "pq_scan_scores differs from the int8 one-hot product")
    m = 2 * half
    nbytes = n * half + m * 16 * q + 4 * q * n   # codes, LUT, scores
    ops = n * m * q                              # one add per lookup
    bms, by = bound(ops, nbytes, PEAK_INT8_OPS)
    info = {"shape": [n, half, q], "max_abs_err": cases["dsub2_q16"][
                "max_abs_err"], "cases": cases, "sweep": sweep,
            **_times(lambda: pqs.pq_scan_scores(p, t),
                     lambda: pqs.pq_scan_scores_plain(p, t),
                     lambda: torch._int_mm(onehot, t)),
            "bound_ms": bms, "bound_by": by, "ops": ops, "bytes": nbytes}
    # the tensor cores' rate: the one-hot product, 2 N (M * 16) Q int8
    # operations, and as the kernel runs it, with Q padded to 16
    info["onehot_tops"] = 2 * n * m * 16 * q / info["device_ms"] / 1e9
    del onehot
    torch.cuda.empty_cache()
    return info


# B6 against its plain version: clipx's fused-versus-unfused bound
# (tests/test_flash_attention.py:280-281). The first stage's codes are
# bitwise; an activation a few ulps off can round a later code the other way
W8A8_REL = 1e-2
MLP_ROWS = 128 * 50   # ViT-B/32's token rows at the indexing batch


# B6's hidden layer, bitwise: the sha256 of the f32 h (R, H) that the up
# GEMM writes at a seeded 6,400 x 768 -> 3,072 input, QuickGELU then erf
# GELU. B6_H_SHA256 holds the digests of h as the mma.sync int8 GEMM that
# the TMA + wgmma GEMM replaced wrote it, taken on the H100 by this
# function before that kernel was deleted: the int32 sums are exact in any
# order, so with the same epilogue h must not move by a bit.
B6_H_SHA256 = {
    "quick": ("359cc6f1df2c9020d12a89f3797e30779e237dea65f0640edc044983c1f8"
              "4af2"),
    "erf": ("80f24e043ccba4cc08d588b9c90a946ffaebd6f9afe232bc1bdcf44821e6"
            "75a9")}


def b6_hidden(device, run) -> dict:
    """{"quick": sha256, "erf": sha256} of the hidden layer that
    ``run(x, w1_q, s1, b1, w2_q, s2, b2, quick, h)`` writes into the
    (R, H) f32 tensor h, at B6's seeded inputs."""
    import hashlib

    from clipx_torch.models import quant

    gen = torch.Generator().manual_seed(SEED + 6)
    w, hid = 768, 3072
    x = _bf16(gen, (MLP_ROWS, w), 1.0, device)
    w1 = (torch.randn((w, hid), generator=gen) * 0.03).to(device)
    w2 = (torch.randn((hid, w), generator=gen) * 0.03).to(device)
    b1 = (torch.randn(hid, generator=gen) * 0.01).to(device)
    b2 = (torch.randn(w, generator=gen) * 0.01).to(device)
    (w1_q, s1), (w2_q, s2) = quant.quantize_weight(w1), quant.quantize_weight(
        w2)
    out = {}
    for tag, quick in (("quick", True), ("erf", False)):
        h = torch.full((MLP_ROWS, hid), float("nan"), device=device)
        run(x, w1_q, s1, b1, w2_q, s2, b2, quick, h)
        torch.cuda.synchronize()
        out[tag] = hashlib.sha256(h.cpu().numpy().tobytes()).hexdigest()
    return out


def _b6_run(x, w1_q, s1, b1, w2_q, s2, b2, quick, h):
    """B6's kernel, writing its hidden layer into h."""
    from clipx_torch.ops import packed_sdpa as ps

    ps.launch_mlp_w8a8(x, w1_q.T.contiguous(), s1, b1, w2_q.T.contiguous(),
                       s2, b2, quick=quick, h=h)


def _kernels_mlp(device, gen) -> dict:
    """B5 fused_attn_sublayer at ViT-B/32's (128, 50, 768) / 12 heads; B7
    fused_mlp and B6 fused_mlp_w8a8 at its MLP, 6,400 rows x 768 -> 3,072
    (QuickGELU), and at 3 x 33 rows. Library yardsticks (never called by
    the port): B5 layer_norm + addmm + SDPA + addmm + add; B7 addmm +
    quick_gelu + addmm; B6 the unfused dense_w8a8 pair on torch._int_mm."""
    import torch.nn.functional as F

    from clipx_torch.models import layers, quant
    from clipx_torch.ops import packed_sdpa as ps

    res = {}
    b, s, w, h = 128, 50, 768, VIT_B32_HEADS
    x = _bf16(gen, (b, s, w), 1.0, device)
    ln_s = (1.0 + 0.1 * torch.randn(w, generator=gen)).to(device)
    ln_b = (0.05 * torch.randn(w, generator=gen)).to(device)
    wqkv = _bf16(gen, (w, 3 * w), 0.03, device)
    wo = _bf16(gen, (w, w), 0.03, device)
    bqkv = (torch.randn(3 * w, generator=gen) * 0.01).to(device)
    bo = (torch.randn(w, generator=gen) * 0.01).to(device)
    args = (x, ln_s, ln_b, wqkv, bqkv, wo, bo)
    ln16, lb16, bqkv16, bo16 = (t.to(torch.bfloat16)
                                for t in (ln_s, ln_b, bqkv, bo))

    def lib_b5():
        y = F.layer_norm(x, (w,), ln16, lb16, 1e-5)
        qkv = torch.addmm(bqkv16, y.view(b * s, w), wqkv)
        q, k, v = qkv.view(b, s, 3, h, 64).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return x + torch.addmm(bo16, o.transpose(1, 2).reshape(b * s, w),
                               wo).view(b, s, w)

    res["fused_attn_sublayer"] = _attn_check(
        "fused_attn_sublayer", lambda: ps.fused_attn_sublayer(*args, heads=h),
        lambda: ps.fused_attn_sublayer_plain(*args, heads=h),
        lambda: ps.fused_attn_sublayer_plain(*_f32(*args), heads=h), lib_b5,
        flops=2 * b * s * w * 4 * w + _attn_flops(b, h, s, 64),
        nbytes=2 * b * s * w * 2 + 4 * w * w * 2 + 6 * w * 4)
    res["fused_attn_sublayer"]["launches"] = _per_launch(
        lambda: ps.fused_attn_sublayer(*args, heads=h),
        _sm90_flops(b, s, w, h), required=("layernorm", "attn_core",
                                           "out_gemm"))
    del x, args, wqkv, wo

    hid = 4 * w
    w1 = (torch.randn((w, hid), generator=gen) * 0.03).to(device)
    w2 = (torch.randn((hid, w), generator=gen) * 0.03).to(device)
    b1 = (torch.randn(hid, generator=gen) * 0.01).to(device)
    b2 = (torch.randn(w, generator=gen) * 0.01).to(device)
    w1_16, w2_16, b1_16, b2_16 = (t.to(torch.bfloat16)
                                  for t in (w1, w2, b1, b2))
    (w1_q, s1), (w2_q, s2) = quant.quantize_weight(w1), quant.quantize_weight(
        w2)
    qargs = (w1_q, s1, b1, w2_q, s2, b2)
    x = _bf16(gen, (MLP_ROWS, w), 1.0, device)
    odd = _bf16(gen, (3, 33, w), 1.0, device)

    # B7, then the odd row count (checks only)
    def b7(t):
        return lambda: ps.fused_mlp(t, w1_16, b1, w2_16, b2)

    def b7_plain(t):
        return lambda: ps.fused_mlp_plain(t, w1_16, b1, w2_16, b2)

    def lib_b7():
        a = layers.quick_gelu(torch.addmm(b1_16, x, w1_16))
        return torch.addmm(b2_16, a, w2_16)

    res["fused_mlp"] = _attn_check(
        "fused_mlp", b7(x), b7_plain(x),
        lambda: ps.fused_mlp_plain(x.float(), w1_16.float(), b1,
                                   w2_16.float(), b2), lib_b7,
        flops=4 * MLP_ROWS * w * hid,
        nbytes=2 * MLP_ROWS * w * 2 + 2 * w * hid * 2 + (hid + w) * 4)
    res["fused_mlp"]["launches"] = _per_launch(
        b7(x), {"up_gemm": 2 * MLP_ROWS * w * hid,
                "down_gemm": 2 * MLP_ROWS * hid * w},
        roles="fused_mlp", required=("up_gemm", "down_gemm"))
    res["fused_mlp"]["odd_rows"] = _attn_check(
        "fused_mlp 3x33", b7(odd), b7_plain(odd),
        lambda: ps.fused_mlp_plain(odd.float(), w1_16.float(), b1,
                                   w2_16.float(), b2))

    # B6: the first stage's codes and scales bitwise, the output within
    # W8A8_REL of max|ref|, at both row counts
    # the K-major weight copies that quantize_mlp_stack makes once
    kmajor = {"w1_qt": w1_q.T.contiguous(), "w2_qt": w2_q.T.contiguous()}
    kargs = (kmajor["w1_qt"], s1, b1, kmajor["w2_qt"], s2, b2)
    cases = {}
    for tag, t in (("rows_6400", x), ("rows_3x33", odd.reshape(-1, w))):
        out, xq, xs = ps.launch_mlp_w8a8(t, *kargs, quick=True)
        ref = ps.fused_mlp_w8a8_plain(t, *qargs, quick=True)
        ref_q, ref_s = quant.quantize_rows(t.float())
        torch.cuda.synchronize()
        check(torch.equal(xq, ref_q) and torch.equal(xs, ref_s.reshape(-1)),
              f"fused_mlp_w8a8 {tag}: first-stage codes differ from plain")
        err = float((out.float() - ref.float()).abs().max())
        cases[tag] = {"max_abs_err": err,
                      "max_abs_ref": float(ref.float().abs().max()),
                      "codes_equal": True}
        check(bool(torch.isfinite(out.float()).all())
              and err <= W8A8_REL * cases[tag]["max_abs_ref"],
              f"fused_mlp_w8a8 {tag} vs plain: max err {err}")

    def lib_b6():
        a = layers.quick_gelu(quant.dense_w8a8(x, w1_q, s1, b1))
        return quant.dense_w8a8(a, w2_q, s2, b2)

    ops = 4 * MLP_ROWS * w * hid
    nbytes = 2 * MLP_ROWS * w * 2 + 2 * w * hid + 2 * (hid + w) * 4
    bms, by = bound(ops, nbytes, PEAK_INT8_OPS)
    res["fused_mlp_w8a8"] = {
        "shape": [MLP_ROWS, w, hid], "max_abs_err": cases["rows_6400"][
            "max_abs_err"], "cases": cases,
        **_times(lambda: ps.fused_mlp_w8a8(x, *qargs, **kmajor),
                 lambda: ps.fused_mlp_w8a8_plain(x, *qargs), lib_b6),
        "bound_ms": bms, "bound_by": by, "ops": ops, "bytes": nbytes,
        "launches": _per_launch(
            lambda: ps.fused_mlp_w8a8(x, *qargs, **kmajor),
            {"up_gemm": 2 * MLP_ROWS * w * hid,
             "down_gemm": 2 * MLP_ROWS * hid * w},
            roles="fused_mlp_w8a8",
            required=("quant_x", "up_gemm", "quant_h", "down_gemm")),
        "hidden_sha256": b6_hidden(device, _b6_run)}
    check(res["fused_mlp_w8a8"]["hidden_sha256"] == B6_H_SHA256,
          "fused_mlp_w8a8's hidden layer differs from the mma.sync GEMM's: "
          f"{res['fused_mlp_w8a8']['hidden_sha256']}")
    torch.cuda.empty_cache()
    return res


def _tile_sweep(device, gen) -> dict:
    """Device ms of each GEMM that B6, B7 and B9 launch, and of B1's out
    projection, at every tile width of csrc/gemm_sm90.cuh (and of
    csrc/gemm_s8_sm90.cuh for B6's int8 GEMMs, "tflops" there being TOP/s)
    that divides its N, read by role from torch.profiler; with the width
    that ``gemm_tile_n_mn`` (B6, B7, B9) or ``gemm_tile_n`` (B1) picks. B7
    at the image tower's 6,400 rows and the text tower's 77 (one query) and
    4,928 (its largest bucket, 64 texts); B6 at the image tower's rows; B9
    and B1 at their kernels-phase shapes."""
    from clipx_torch.ops import packed_sdpa as ps

    res = {}

    def record(key, m, n, k, bn, ms, rule):
        r = res.setdefault(key, {"m": m, "n": n, "k": k, "rule": rule,
                                 "device_ms": {}, "tflops": {}})
        r["device_ms"][bn] = ms
        r["tflops"][bn] = 2 * m * n * k / ms / 1e9

    for tag, (rows, w, hid) in {"image": (MLP_ROWS, 768, 3072),
                                "text_1": (77, 512, 2048),
                                "text_64": (77 * 64, 512, 2048)}.items():
        x = _bf16(gen, (rows, w), 1.0, device)
        w1 = _bf16(gen, (w, hid), 0.03, device)
        w2 = _bf16(gen, (hid, w), 0.03, device)
        b1 = (torch.randn(hid, generator=gen) * 0.01).to(device)
        b2 = (torch.randn(w, generator=gen) * 0.01).to(device)
        for bn in ps.GEMM_TILES:
            up = bn if hid % bn == 0 else None
            down = bn if w % bn == 0 else None
            if up is None and down is None:
                continue
            split = _per_launch(
                lambda: ps._launch_mlp(x, w1, b1, w2, b2, True, (up, down)),
                {}, roles="fused_mlp", required=("up_gemm", "down_gemm"))
            if up:
                record(f"fused_mlp_up_{tag}", rows, hid, w, bn,
                       split["up_gemm"]["device_ms"],
                       ps.gemm_tile_n_mn(rows, hid))
            if down:
                record(f"fused_mlp_down_{tag}", rows, w, hid, bn,
                       split["down_gemm"]["device_ms"],
                       ps.gemm_tile_n_mn(rows, w))
        del x, w1, w2

    # B6's two int8 GEMMs at the image tower's 6,400 rows
    from clipx_torch.models import quant

    rows, w, hid = MLP_ROWS, 768, 3072
    x = _bf16(gen, (rows, w), 1.0, device)
    (w1_q, s1), (w2_q, s2) = (quant.quantize_weight(
        torch.randn(shape, generator=gen).to(device) * 0.03)
        for shape in ((w, hid), (hid, w)))
    b1 = (torch.randn(hid, generator=gen) * 0.01).to(device)
    b2 = (torch.randn(w, generator=gen) * 0.01).to(device)
    w1_qt, w2_qt = w1_q.T.contiguous(), w2_q.T.contiguous()
    for bn in ps.GEMM_TILES:
        split = _per_launch(
            lambda: ps.launch_mlp_w8a8(x, w1_qt, s1, b1, w2_qt, s2, b2,
                                       quick=True, tiles=(bn, bn)), {},
            roles="fused_mlp_w8a8",
            required=("quant_x", "up_gemm", "quant_h", "down_gemm"))
        record("fused_mlp_w8a8_up", rows, hid, w, bn,
               split["up_gemm"]["device_ms"], ps.gemm_tile_n_mn(rows, hid))
        record("fused_mlp_w8a8_down", rows, w, hid, bn,
               split["down_gemm"]["device_ms"], ps.gemm_tile_n_mn(rows, w))
    del x, w1_q, w2_q, w1_qt, w2_qt

    b, s, w, h = 128, 577, 1024, 16
    qkv = _bf16(gen, (b, s, 3 * w), 1.0, device)
    wo = _bf16(gen, (w, w), 0.03, device)
    bo = (torch.randn(w, generator=gen) * 0.01).to(device)
    for bn in ps.GEMM_TILES:
        if w % bn == 0:
            split = _per_launch(
                lambda: ps._launch_long_qkv(qkv, wo, bo, h, False, bn), {},
                roles="fused_sdpa_long_qkv",
                required=("attention", "out_gemm"))
            record("fused_sdpa_long_qkv_out", b * s, w, w, bn,
                   split["out_gemm"]["device_ms"], ps.gemm_tile_n_mn(b * s, w))
    del qkv, wo

    b, s, w, h = 128, 50, 768, VIT_B32_HEADS
    x = _bf16(gen, (b, s, w), 1.0, device)
    wqkv = _bf16(gen, (w, 3 * w), 0.03, device)
    wo = _bf16(gen, (w, w), 0.03, device)
    bqkv = (torch.randn(3 * w, generator=gen) * 0.01).to(device)
    bo = (torch.randn(w, generator=gen) * 0.01).to(device)
    for bn in ps.GEMM_TILES:
        split = _per_launch(
            lambda: ps._launch_attn_block(x, wqkv, bqkv, wo, bo, h, bn), {})
        record("fused_attn_block_out", b * s, w, w, bn,
               split["out_gemm"]["device_ms"], ps.gemm_tile_n(w))
    for r in res.values():
        r["fastest"] = min(r["device_ms"], key=r["device_ms"].get)
        r["rule_over_fastest"] = (r["device_ms"][r["rule"]]
                                  / r["device_ms"][r["fastest"]])
    torch.cuda.empty_cache()
    return res


SDPA_SOURCE = "clipx_torch/csrc/sdpa.cu"
KERNEL_TABLE = (
    # name, source, the Pallas kernel it replaces
    ("fused_attn_block", "clipx_torch/csrc/attn_block.cu",
     "clipx/ops/packed_sdpa.py:312"),
    ("packed_sdpa", SDPA_SOURCE,
     "clipx/ops/packed_sdpa.py:763"),
    ("packed_sdpa_rows", SDPA_SOURCE,
     "clipx/ops/packed_sdpa.py:548"),
    ("packed_sdpa_qkv", SDPA_SOURCE,
     "clipx/ops/packed_sdpa.py:144"),
    ("fused_sdpa_long", SDPA_SOURCE,
     "clipx/ops/packed_sdpa.py:621"),
    ("fused_sdpa_long_qkv", SDPA_SOURCE,
     "clipx/ops/packed_sdpa.py:715"),
    ("flash_attention", SDPA_SOURCE,
     "clipx/ops/flash_attention.py:64"),
    ("pq_scan_scores", "clipx_torch/csrc/pq_scan.cu",
     "clipx/ops/pq_scan.py:106"),
    ("fused_attn_sublayer", "clipx_torch/csrc/attn_block.cu",
     "clipx/ops/packed_sdpa.py:261"),
    ("fused_mlp_w8a8", "clipx_torch/csrc/mlp.cu",
     "clipx/ops/packed_sdpa.py:458"),
    ("fused_mlp", "clipx_torch/csrc/mlp.cu",
     "clipx/ops/packed_sdpa.py:504"),
)


def kernels_line(results: dict, launches: dict, ptxas: dict) -> dict:
    """One row a kernel; the rows of the SDPA kernel, B11 and B6 carry
    their kernels' ptxas lines (``kernels_ptxas``)."""
    rows = []
    for name, source, replaces in KERNEL_TABLE:
        r = results[name]
        key = ("sdpa" if source == SDPA_SOURCE else
               {"pq_scan_scores": "pq_scan",
                "fused_mlp_w8a8": "mlp"}.get(name))
        extra = {"ptxas": ptxas[key]} if key else {}
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "device_ms": r["device_ms"],
                     "plain_device_ms": r["plain_device_ms"],
                     "library_device_ms": r["library_device_ms"], **extra})
    return {"kernels": rows}


# ---------------------------------------------------------------------------
# phases 3-5: the main path
# ---------------------------------------------------------------------------

N_IMAGES, BATCH, CPU_CHECK = 1024, 128, 4
# the kernels that only opt-in routes launch (B5, B6, B7)
OPT_IN_KERNELS = ("fused_attn_sublayer", "fused_mlp", "fused_mlp_w8a8")
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
    return {"embs": embs, "info": info, "cpu_ref": ref, "cpu": cpu}


def text_latency(enc) -> dict:
    """encode_texts of one query, 30 timed calls after 3 warm-ups."""
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
    return {"calls": len(times), "p50_ms": statistics.median(times) * 1e3,
            "min_ms": min(times) * 1e3}


def phase_text(enc) -> dict:
    info = {"phase": "text", **text_latency(enc)}
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase parity: the real-weight parity gate (clipx_torch/tools/parity_check)
# ---------------------------------------------------------------------------

# tools/make_golden.py's prompts and images (copied: this script imports
# nothing of the root tools/ folder)
GOLDEN_PROMPTS = [
    "a photo of a cat",
    "a diagram of the solar system",
    "two people walking on a beach at sunset",
    "macro shot of a dew drop on a leaf",
    "screenshot of a terminal with green text",
    "an oil painting of mountains in winter",
]
PARITY_MODEL = "ViT-B/32"   # unarmed: the preset of the seeded tree
PARITY_BUDGET_S = 30.0


def golden_images(size: int, n: int = 6) -> np.ndarray:
    """tools/make_golden.py's synthetic_images: gradients and checkers."""
    rng = np.random.RandomState(0)
    out = np.zeros((n, size, size, 3), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(n):
        r = 127 + 127 * np.sin(2 * np.pi * (xx * (i + 1) + rng.rand()))
        g = 255 * yy
        b = 255 * (((xx * 8).astype(int) + (yy * 8).astype(int)) % 2)
        out[i] = np.stack([r, g, b.astype(np.float32)], -1).astype(np.uint8)
    return out


def phase_parity(device, cpu) -> dict:
    """The real-weight parity gate on the card. Armed ($CLIPX_CHECKPOINT,
    the BPE merge table and the golden file all present): the golden case
    at clipx's cosine 0.999. Not armed: the gate's machinery at ViT-B/32
    full width on seeded weights, i.e. the seed-0 tree written as an .npz
    into a temporary directory, a golden file in make_golden's layout from
    ``cpu`` (phase encode's CPU f32 encoder of that tree), and the card's
    bf16 Encoder.create(checkpoint=that .npz) held to it at COS_MIN. Either
    way the checkpoint's tree must match its preset's, and the golden
    images as one batch (bucket 8) must launch B1 once a layer and each
    image alone (bucket 1) B2 once a layer."""
    from clipx_torch import config as config_lib
    from clipx_torch.models import convert
    from clipx_torch.runtime.encoder import Encoder
    from clipx_torch.text.tokenizer import ClipTokenizer
    from clipx_torch.tools import parity_check as pc

    t0 = time.perf_counter()
    ckpt, golden = os.environ.get("CLIPX_CHECKPOINT"), pc.golden_path()
    missing = pc.missing_artifacts(ckpt, golden, ClipTokenizer())
    info = {"phase": "parity", "armed": not missing}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parity_") as tmp:
        if missing:
            emit({"phase": "parity", "armed": False, "missing": missing})
            model, threshold = PARITY_MODEL, COS_MIN
            ckpt = os.path.join(tmp, "vit_b32.npz")
            golden = os.path.join(tmp, "clip_golden.npz")
            convert.save_params(ckpt, convert.init_params(
                config_lib.get_config(model), SEED))
            images = golden_images(cpu.image_size)
            np.savez(golden, model=model, texts=np.array(GOLDEN_PROMPTS),
                     text_emb=cpu.encode_texts(GOLDEN_PROMPTS),
                     images_uint8=images, image_emb=cpu.encode_images(images))
            info["npz_bytes"] = os.path.getsize(ckpt)
        else:
            model, threshold = pc.golden_model(golden), pc.GOLDEN_COS_MIN
        info.update(model=model, setup_s=time.perf_counter() - t0)
        mismatch = pc.tree_mismatch(ckpt, model)
        check(mismatch == {}, f"the checkpoint's tree is not {model}'s: "
                              f"{mismatch}")
        enc = Encoder.create(model, checkpoint=ckpt, device=device)
        before = kernel_counts()
        cos = pc.golden_cosines(enc, golden)
        launched = {k: n - before[k] for k, n in kernel_counts().items()
                    if n != before[k]}
    failures = pc.golden_failures(cos, threshold)
    check(not failures, f"parity gate ({model}): {failures}")
    layers, n = enc.cfg.vision.layers, cos["image"].shape[0]
    check(launched == {"fused_attn_block": layers, "packed_sdpa": n * layers},
          f"the gate's encodes launched {launched}, not B1 {layers} and B2 "
          f"{n * layers} times")
    info.update({f"cos_{kind}_min": float(c.min()) for kind, c in cos.items()})
    info.update(cos_tolerance=threshold, launches=launched,
                seconds=time.perf_counter() - t0, budget_s=PARITY_BUDGET_S)
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


def phase_search(embs: np.ndarray, device, keep: str) -> dict:
    """The phase-3 embeddings through the KV store (kept in ``keep`` for
    phase tools' kv_tool) and images.index and back, then
    ``corpus_search``."""
    from clipx_torch.search.engine import IndexWriter, read_index_vectors
    from clipx_torch.store.kv import open_env

    n = embs.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        env = open_env(os.path.join(keep, "vectors.lmdb"))
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

    found = corpus_search(stored, device, DIM)
    info = {"phase": "search", **found["info"]}
    emit(info)
    return found


def corpus_search(stored: np.ndarray, device, dim: int) -> dict:
    """Exact and quant ("int8-seg") search p50 at k = 50 over a seeded
    1,000,000 x dim unit-norm f32 corpus plus ``stored``, with 16 queries
    (8 of the stored rows, 8 perturbed corpus rows); quant ids must equal
    exact ids apart from the near-duplicate exception."""
    from clipx_torch.search.engine import VectorIndex

    n = stored.shape[0]
    gen = torch.Generator(device=device).manual_seed(SEED)
    corpus = torch.randn((CORPUS_ROWS, dim), generator=gen, device=device)
    corpus /= torch.linalg.vector_norm(corpus, dim=1, keepdim=True)
    exact = VectorIndex(dim, quantized=False, device=device)
    exact.add(corpus)
    exact.add(stored)
    # 8 encoded images and 8 perturbed corpus rows as queries
    picks = torch.randint(0, CORPUS_ROWS, (NQ // 2,), generator=gen,
                          device=device)
    noisy = corpus[picks] + 0.05 * torch.randn(
        (NQ // 2, dim), generator=gen, device=device)
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
    info = {"rows": total, "dim": dim, "k": K,
            "queries": NQ, "exact_p50_ms": exact_ms,
            "quant_p50_ms": quant_ms,
            "quant_rows_identical": int(same.sum()),
            "quant_rows_near_dup_exception": int((~same).sum()),
            "max_abs_score_diff": float(np.abs(Dq - De).max())}
    quant.quantized = False
    return {"index": exact, "queries": queries, "ids": Ie, "scores": De,
            "quant_ids": Iq, "quant_scores": Dq,
            "picks": picks.cpu().numpy(), "info": info}


# ---------------------------------------------------------------------------
# phase: the coded tiers
# ---------------------------------------------------------------------------

CODED_TIERS = ("int8", "int4", "pq")
CAPACITY_ROWS = 1 << 24   # 2 GiB of dsub-2 pq codes; f32 would need 32 GiB


def _tier_checks(tier, D, I, exact_ids, picks, total) -> dict:
    check(I.shape == (NQ, K) and bool((I >= 0).all())
          and bool((I < total).all()) and bool(np.isfinite(D).all()),
          f"{tier}: result shape/ids out of range")
    check(bool((np.diff(D, axis=1) <= 0).all()), f"{tier}: scores not sorted")
    check(bool((I[NQ // 2:, 0] == picks).all()),
          f"{tier}: a perturbed corpus row did not find itself first")
    recall = np.array([len(set(a) & set(b)) / K
                       for a, b in zip(I, exact_ids)])
    top1 = I[:, 0] == exact_ids[:, 0]
    # queries 0-7 are encoded images (their neighbours: the other tightly
    # clustered image rows), 8-15 perturbed corpus rows
    return {"recall_at_50": float(recall.mean()),
            "top1": float(top1.mean()),
            "recall_at_50_image_queries": float(recall[:NQ // 2].mean()),
            "recall_at_50_row_queries": float(recall[NQ // 2:].mean()),
            "top1_image_queries": float(top1[:NQ // 2].mean())}


def _search_profile(index, queries, p50_ms: float) -> dict:
    """torch.profiler over 5 searches: device ms per search, the card's
    busy share of the unprofiled p50, and the top kernels by device time."""
    kernels, _ = _profiled(lambda: index.search(queries, K), 5)
    busy = sum(ms for _, ms, _ in kernels)
    return {"device_ms": busy, "device_busy_share": busy / p50_ms,
            "top_kernels": [{"name": name[:60], "ms": ms, "calls": n}
                            for name, ms, n in kernels[:4]]}


def _coded_args(search: dict, tier: str):
    import argparse

    return argparse.Namespace(index=os.path.join(search["coded_dir"],
                                                 f"{tier}.index"),
                              corpus_dtype=tier, search_mode="auto",
                              device=search["device"])


def _coded_tier(search: dict, tier: str, tiers: dict) -> None:
    """One coded tier of phase coded: its codes file loaded with the
    sidecar present (no re-encode), search p50, recall and a profile; then
    codes-only with the sidecar's link deleted (the same answers), and its
    payload kept for phases ivf and sharded."""
    from clipx_torch.cli import common
    from clipx_torch.search import codes_io

    queries, total = search["queries"], search["rows"].shape[0]
    args = _coded_args(search, tier)
    codes = codes_io.codes_path(args.index)
    written = os.stat(codes).st_mtime_ns
    t0 = time.perf_counter()
    idx = common.load_coded_index(args)
    tiers[tier]["load_s"] = time.perf_counter() - t0
    check(idx is not None and idx.ntotal == total and idx.dtype == tier,
          f"{tier}: codes file did not load")
    check(os.stat(codes).st_mtime_ns == written,
          f"{tier}: the load re-encoded the codes file")
    D, I, p50 = _search_p50(idx, queries, K)
    tiers[tier].update(p50_ms=p50, **_tier_checks(
        tier, D, I, search["ids"], search["picks"], total),
        **_search_profile(idx, queries, p50))
    del idx
    # phase sharded holds its sharded tiers against these
    search.setdefault("tier_results", {})[tier] = (D, I)
    os.remove(args.index)
    t0 = time.perf_counter()
    idx = common.load_coded_index(args)
    tiers[tier]["codes_only_load_s"] = time.perf_counter() - t0
    Dc, Ic = idx.search(queries, K)
    check(np.array_equal(Ic, I) and np.array_equal(Dc, D),
          f"{tier}: codes-only boot searches differently")
    del idx
    # phase ivf installs these codes into its IVF layout
    payload = codes_io.load_codes(args.index, tier, rotated=True,
                                  orphan=True)
    for key in ("codes", "scales"):
        if payload[key] is not None:
            payload[key] = np.array(payload[key])
    search.setdefault("payloads", {})[tier] = payload


def phase_coded(search: dict, device, keep: str, pool, beside=()) -> dict:
    """The coded tiers on phase search's corpus: images.index written, the
    port's write_codes_file for int8 and int4, each loaded through
    load_coded_index with the sidecar present and then codes-only with it
    deleted; bf16 through build_index_from_vectors. Search p50 of phase
    search's 16 queries at k = 50 per tier, recall@50 and top-1 against
    its exact ids (no floor). Then a capacity scan: a seeded random-code pq
    payload of 2^24 rows placed through VectorIndex.from_codes, Q = 1 (one
    scan of the whole capacity) and 16 (chunks of 2^21 rows).

    The pq tier's encode (dsub 2, trained OPQ: minutes on the host) is
    submitted to ``pool`` first and runs beside this phase and the ones
    after it; phase coded_pq loads and searches it. ``beside`` holds the
    futures of the other work beside this phase (module docstring): this
    thread encodes int8 and int4 meanwhile and waits for them before it
    times its first search. Each encode_s is its encode's wall under that
    sharing of the host."""
    from clipx_torch.cli import common
    from clipx_torch.search.engine import IndexWriter

    rows, queries = search["rows"], search["queries"]
    total = rows.shape[0]
    search.pop("index", None)
    torch.cuda.empty_cache()
    # one index path per tier (an index has one codes file), each a hard
    # link to the same images.index; kept until phase coded_pq
    search["coded_dir"] = os.path.join(keep, "coded")
    search["device"] = device
    os.makedirs(search["coded_dir"])
    sidecar = os.path.join(search["coded_dir"], "images.index")
    writer = IndexWriter(sidecar, total, DIM)
    writer.write(rows)
    writer.close()
    search["content_hash"] = writer.content_hash
    for tier in CODED_TIERS:
        os.link(sidecar, _coded_args(search, tier).index)
    search["pq_encode"] = pool.submit(_encode_codes, search, "pq")
    tiers = {tier: _encode_codes(search, tier) for tier in CODED_TIERS[:-1]}
    for job in beside:
        job.result()
    for tier in CODED_TIERS[:-1]:
        _coded_tier(search, tier, tiers)
    t0 = time.perf_counter()
    bf16 = common.build_index_from_vectors(rows, _coded_args(search, "bf16"))
    tiers["bf16"] = {"build_s": time.perf_counter() - t0}
    D, I, p50 = _search_p50(bf16, queries, K)
    tiers["bf16"].update(p50_ms=p50, **_tier_checks(
        "bf16", D, I, search["ids"], search["picks"], total),
        **_search_profile(bf16, queries, p50))
    del bf16
    torch.cuda.empty_cache()
    info = {"phase": "coded", "rows": total, "dim": DIM, "k": K,
            "queries": NQ, "tiers": tiers,
            "capacity": _capacity_scan(device)}
    emit(info)
    return info


def _encode_codes(search: dict, tier: str) -> dict:
    from clipx_torch.search import codes_io
    from clipx_torch.search.engine import corpus_rotation

    index = _coded_args(search, tier).index
    t0 = time.perf_counter()
    codes_io.write_codes_file(index, search["rows"], tier,
                              rot=corpus_rotation(DIM),
                              content_hash=search["content_hash"])
    return {"encode_s": time.perf_counter() - t0,
            "codes_bytes": os.path.getsize(codes_io.codes_path(index))}


def phase_coded_pq(search: dict, keep: str) -> dict:
    """Phase coded's pq tier, once its encode (begun there) has ended: the
    same loads, searches and checks as the int8 and int4 tiers. The pq
    deployment (images.index and its codes) stays in ``keep`` for phase
    tools' load_timing and drop-f32."""
    from clipx_torch.search import codes_io

    t0 = time.perf_counter()
    tiers = {"pq": search.pop("pq_encode").result()}
    tiers["pq"]["waited_s"] = time.perf_counter() - t0
    index = _coded_args(search, "pq").index
    kept = os.path.join(keep, "images.index")
    os.link(index, kept)
    os.link(codes_io.codes_path(index), codes_io.codes_path(kept))
    _coded_tier(search, "pq", tiers)
    shutil.rmtree(search.pop("coded_dir"))
    info = {"phase": "coded_pq", "rows": search["rows"].shape[0],
            "dim": DIM, "k": K, "queries": NQ, "tiers": tiers}
    emit(info)
    return info


def _capacity_scan(device) -> dict:
    from clipx_torch.search import pq as pq_lib
    from clipx_torch.search.engine import VectorIndex

    rng = np.random.default_rng(SEED)
    half = DIM // 2 // 2
    t0 = time.perf_counter()
    payload = {
        "tier": "pq", "ntotal": CAPACITY_ROWS, "dim": DIM, "code_dim": half,
        "codes": np.frombuffer(rng.bytes(CAPACITY_ROWS * half),
                               np.int8).reshape(CAPACITY_ROWS, half),
        "centroids": rng.standard_normal((2 * half, pq_lib.PQ_K, 2),
                                         dtype=np.float32) * 0.05,
        "rot_matrix": None, "center": None}
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = VectorIndex.from_codes(payload, device=device)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    cap = idx._codes.shape[0]
    check(pq_lib._scan_chunk(cap, 1) == cap
          and pq_lib._scan_chunk(cap, NQ) < cap,
          "the capacity scan does not take one scan at Q = 1 and chunks "
          f"at Q = {NQ}")
    out = {"rows": CAPACITY_ROWS, "codes_gib": CAPACITY_ROWS * half / 2**30,
           "make_s": make_s, "place_s": place_s}
    q_all = rng.standard_normal((NQ, DIM), dtype=np.float32)
    for nq in (1, NQ):
        D, I, p50 = _search_p50(idx, q_all[:nq], K, reps=10)
        check(I.shape == (nq, K) and bool((I >= 0).all())
              and bool((I < CAPACITY_ROWS).all())
              and bool(np.isfinite(D).all())
              and bool((np.diff(D, axis=1) <= 0).all()),
              f"capacity scan Q={nq}: bad results")
        # returned scores are the f32 PQ scores of the returned rows
        want = np.einsum("qd,qkd->qk", q_all[:nq],
                         np.stack([[idx.reconstruct(int(i)) for i in r[:4]]
                                   for r in I]))
        check(bool(np.allclose(D[:, :4], want, atol=1e-4, rtol=1e-4)),
              f"capacity scan Q={nq}: scores differ from the decoded rows")
        out[f"p50_ms_q{nq}"] = p50
    del idx
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase: IVF search (--search-mode ivf)
# ---------------------------------------------------------------------------

IVF_NPROBES = (1, 32, 100)
# the residual IVF-PQ leg's corpus: the last IVF_PQ_ROWS rows of phase
# search's corpus (the encoded images among them). Its encode (trained OPQ
# on the residuals, then every row, on the host) took 2 to 2.5 minutes at
# 262,144 rows, and the whole run came near its time limit, so it is cut
# to 131,072; PERF.md lists the cut. The other coded legs install phase
# coded's codes files at full size
IVF_PQ_ROWS = 131_072
# timed searches a p50, by query count: a fixed number, so the B11 launch
# totals repeat from run to run (the slowest search, int4 at nprobe 100
# and Q = 16, took under 0.1 s)
IVF_REPS = {1: 20, NQ: 10}
# scores closer than this are ties up to f32 summation order (a few ulps)
TIE = 2e-6


def _same_ranking(D, I, De, Ie, atol: float = 1e-5,
                  tie: float = TIE) -> bool:
    """(D, I) equal to (De, Ie): scores within atol, ids identical except
    within a run of reference scores closer than tie (the same set there;
    a run that reaches rank k may end in other rows of the same score)."""
    if D.shape != De.shape or not np.allclose(D, De, atol=atol, rtol=0):
        return False
    k = Ie.shape[1]
    for d, ours, ref in zip(De, I, Ie):
        start = 0
        while start < k:
            end = start + 1
            while end < k and d[end - 1] - d[end] <= tie:
                end += 1
            if end - start == 1:
                if ours[start] != ref[start]:
                    return False
            elif end < k and set(ours[start:end]) != set(ref[start:end]):
                return False
            start = end
    return True


@contextlib.contextmanager
def _refuse_plain(path: str, plains):
    """Each (module, name) of plains raises inside the block: on the card
    every call of path must run the kernels."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in plains]

    def refuser(name):
        def refuse(*args, **kwargs):
            raise Failed(f"the {path} called {name} on the card")
        return refuse

    for mod, name, _ in saved:
        setattr(mod, name, refuser(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _no_plain_pq_scan():
    """pq_scan_scores_plain raises inside the block: on the card every
    chunk of the IVF-PQ probe must run B11's kernel."""
    from clipx_torch.ops import pq_scan as pqs

    return _refuse_plain("IVF path", [(pqs, "pq_scan_scores_plain")])


def _ivf_leg(idx, queries, exact_ids) -> dict:
    """For each nprobe: the probe bucket P, search p50 at Q = 1 and 16,
    recall@50 of the 16 queries against exact_ids, and torch.profiler over
    5 searches at Q = 1 (device ms, busy share of the p50, and for pq the
    B11 launches and their device ms). For pq, B11 must launch once per
    (query, probed chunk). Each nprobe's seconds go to stderr."""
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.search import ivf as tivf

    out = {}
    t_leg = time.perf_counter()
    for nprobe in IVF_NPROBES:
        idx.nprobe = nprobe
        P = idx.probe_bucket(K)
        r = {"P": P}
        if idx.pq_storage:
            r["chunks"] = -(-P // tivf._pq_chunk_segs(P, 64))
        for nq in (1, NQ):
            before = ps.LAUNCHES["pq_scan_scores"]
            D, I = idx.search(queries[:nq], K)
            b11 = ps.LAUNCHES["pq_scan_scores"] - before
            if idx.pq_storage:
                check(b11 == nq * r["chunks"],
                      f"IVF-PQ nprobe {nprobe} Q={nq}: B11 launched {b11} "
                      f"times, expected {nq * r['chunks']} (one per query "
                      "and probed chunk)")
                r[f"b11_launches_q{nq}"] = b11
            else:
                check(b11 == 0, f"IVF {idx.dtype} launched B11")
            times = []
            for _ in range(IVF_REPS[nq]):
                t0 = time.perf_counter()
                idx.search(queries[:nq], K)
                times.append(time.perf_counter() - t0)
            r[f"p50_ms_q{nq}"] = statistics.median(times) * 1e3
        check(I.shape == (NQ, K) and bool((I >= 0).all())
              and bool(np.isfinite(D).all())
              and bool((np.diff(D, axis=1) <= 0).all()),
              f"IVF {idx.dtype} nprobe {nprobe}: bad results")
        r["recall_at_50"] = float(np.mean(
            [len(set(a) & set(b)) / K for a, b in zip(I, exact_ids)]))
        kernels, _ = _profiled(lambda: idx.search(queries[:1], K), 5)
        r["device_ms_q1"] = sum(ms for _, ms, _ in kernels)
        r["device_busy_share_q1"] = r["device_ms_q1"] / r["p50_ms_q1"]
        if idx.pq_storage:
            b11 = [(ms, n) for name, ms, n in kernels if "pq_scan" in name]
            r["b11_device_ms_q1"] = sum(ms for ms, _ in b11)
            r["b11_kernel_calls_q1"] = sum(n for _, n in b11)
        r["top_kernels_q1"] = [{"name": name[:60], "ms": ms, "calls": n}
                               for name, ms, n in kernels[:3]]
        out[str(nprobe)] = r
        print(f"[ivf] {idx.dtype} nprobe {nprobe}: "
              f"{time.perf_counter() - t_leg:.1f} s", file=sys.stderr,
              flush=True)
    return out


def _ivf_probe_chunks(idx, queries, device) -> dict:
    """B11 against its plain version, bitwise, on every probed chunk of
    query 0 at nprobe 100 (the probe's own (rows, M/2) gathers: dead
    padding rows of ragged segments, and a ragged last chunk where the
    segment count leaves one), the device ms of one full chunk, and of the
    flat scan of all idx's rows at Q = 1."""
    from clipx_torch.ops import pq_scan as pqs
    from clipx_torch.search import ivf as tivf
    from clipx_torch.search import pq as pq_lib
    from clipx_torch.search.engine import rotate_rows

    P = idx.probe_bucket(K, 100)
    pc = tivf._pq_chunk_segs(P, 64)
    with torch.inference_mode():
        q1 = torch.from_numpy(rotate_rows(queries[:1], idx._rot)).to(device)
        _, seg_idx = tivf._coarse(q1, idx._seg_cent, P)
        _, luti, _ = pq_lib.quantized_luts(q1, idx._pq.device(device))
        col = luti[0][:, None]
        ragged = False
        for s0 in range(0, P, pc):
            cs = seg_idx[0, s0: s0 + pc]
            chunk = idx._codes3[cs].reshape(len(cs) * 64, -1)
            ragged |= not bool(idx._valid2[cs].all())
            out = pqs.pq_scan_scores(chunk, col)
            ref = pqs.pq_scan_scores_plain(chunk, col)
            torch.cuda.synchronize()
            check(torch.equal(out, ref), f"B11 differs from plain on IVF "
                  f"chunk {s0 // pc}: max err "
                  f"{float((out - ref).abs().max())}")
        check(ragged, "no checked IVF chunk held a ragged segment")
        first = idx._codes3[seg_idx[0, :pc]].reshape(pc * 64, -1)
        flat = idx._codes3.reshape(-1, idx._codes3.shape[-1])
        return {"P": P, "chunk_rows": pc * 64, "chunks": -(-P // pc),
                "last_chunk_rows": (P - (P - 1) // pc * pc) * 64,
                "bitwise": True, "ragged_segment_checked": ragged,
                "chunk_b11_device_ms": device_ms(
                    lambda: pqs.pq_scan_scores(first, col)),
                "flat_rows": flat.shape[0],
                "flat_b11_device_ms_q1": device_ms(
                    lambda: pqs.pq_scan_scores(flat, col))}


def _residual_build(sub: np.ndarray, device, keep: str):
    """Phase ivf's residual pq index (the default, CLIPX_PQ_RESIDUAL unset)
    on ``sub``: k-means on the card, then the residual OPQ training and
    encode on the host, its .ivf cache in ``keep``. Runs in a thread beside
    phases coded to resnet: minutes of host work that time no search.
    Returns (index, build seconds, cache path)."""
    from clipx_torch.search import ivf as tivf

    res_cache = os.path.join(keep, "residual.ivf")
    t0 = time.perf_counter()
    idx = tivf.IVFIndex.from_vectors(sub, dtype="pq", device=device,
                                     cache_path=res_cache, stash_codes=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(idx._residual, "IVF pq_residual: codes are not residual")
    return idx, build_s, res_cache


def phase_ivf(search: dict, device, keep: str) -> dict:
    """IVF search (clipx_torch/search/ivf.py) on phase search's corpus:
    k-means on the card (twice: the same layout digest), the layout saved
    as an .ivf cache, then through that cache f32 (IVFIndex.from_vectors,
    quantized, as --search-mode ivf makes it from 100k rows; unquantized at
    nprobe 100 it must return phase search's exact ids), and int8, int4
    and non-residual pq from phase coded's codes files
    (IVFIndex.from_codes, the codes-file start). Residual pq, the default,
    on the last IVF_PQ_ROWS rows, against a flat exact search of those
    rows (built by _residual_build beside phases coded to resnet). Each
    leg through _ivf_leg, with pq_scan_scores_plain refused.
    Returns the info and the launch counts of these searches; the
    B11-versus-plain checks of _ivf_probe_chunks run after the counts are
    read. For phase sharded it keeps (in ``keep`` and ``search``) both .ivf
    caches, the unquantized f32 ranking at nprobe 100 and the residual pq
    leg's flat-order codes."""
    from clipx_torch.search import ivf as tivf
    from clipx_torch.search.engine import VectorIndex, content_hash

    rows, queries = search["rows"], search["queries"]
    exact_D, exact_ids = search["scores"], search["ids"]
    info = {"phase": "ivf", "rows": rows.shape[0], "dim": rows.shape[1],
            "k": K, "queries": NQ, "residual_pq_rows": IVF_PQ_ROWS}
    tiers = {}
    with tempfile.TemporaryDirectory() as tmp, _no_plain_pq_scan():
        t0 = time.perf_counter()
        assign, _ = tivf.train_clusters(rows, device=device)
        info["kmeans_s"] = time.perf_counter() - t0
        layout = tivf.cluster_layout(assign)
        digest = tivf.layout_digest(layout)
        again = tivf.train_clusters(rows, device=device)[0]
        check(tivf.layout_digest(tivf.cluster_layout(again)) == digest,
              "two k-means builds on the card gave two layouts")
        info.update(clusters=int(assign.max()) + 1,
                    segments=len(layout) // 64, layout_digest=digest.hex(),
                    two_builds_one_layout=True)
        cache = search["ivf_cache"] = os.path.join(keep, "corpus.ivf")
        t0 = time.perf_counter()
        tivf._save_cache(cache, rows, layout)
        info["cache_save_s"] = time.perf_counter() - t0
        for tier in ("f32", "int8", "int4", "pq"):
            t0 = time.perf_counter()
            if tier == "f32":
                idx = tivf.IVFIndex.from_vectors(rows, quantized=True,
                                                 cache_path=cache,
                                                 device=device)
            else:  # phase coded's flat (for pq: non-residual) codes
                idx = tivf.IVFIndex.from_codes(search["payloads"][tier],
                                               cache, quantized=True,
                                               device=device)
            torch.cuda.synchronize()
            install_s = time.perf_counter() - t0
            check(idx is not None and np.array_equal(idx._row_ext, layout),
                  f"IVF {tier}: the .ivf cache did not load")
            tiers[tier] = {"install_s": install_s,
                           **_ivf_leg(idx, queries, exact_ids)}
            if tier == "f32":
                idx.quantized = False
                D, I = idx.search(queries, K, nprobe=100)
                check(_same_ranking(D, I, exact_D, exact_ids),
                      "f32 IVF at nprobe 100 differs from the exact search")
                search["ivf_full"] = (D, I)
                tiers["f32_exact"] = {"full_probe_equals_exact": True,
                                      **_ivf_leg(idx, queries, exact_ids)}
            del idx
            torch.cuda.empty_cache()

        sub = rows[-IVF_PQ_ROWS:]
        flat = VectorIndex(rows.shape[1], device=device)
        flat.add(sub)
        _, sub_ids = flat.search(queries, K)
        del flat
        idx, build_s, res_cache = search.pop("residual_build")
        # the install's flat-order residual codes, as a codes-file payload
        search["ivf_residual"] = {
            "cache": res_cache, "ids": sub_ids,
            "payload": dict(idx._pending_codes_payload, tier="pq",
                            ntotal=sub.shape[0], dim=DIM,
                            content_hash=content_hash(sub))}
        idx._pending_codes_payload = None
        # k-means on these rows, the residual OPQ training and encode, in
        # a thread beside phases coded to resnet
        tiers["pq_residual"] = {"build_s": build_s,
                                **_ivf_leg(idx, queries, sub_ids)}
        launches = kernel_counts()
    info["probe_chunks"] = _ivf_probe_chunks(idx, queries, device)
    info["tiers"] = tiers
    del idx
    torch.cuda.empty_cache()
    emit(info)
    return {"info": info, "launches": launches}


# ---------------------------------------------------------------------------
# phase: the HTTP service (python -m clipx_torch.serve)
# ---------------------------------------------------------------------------

# closed-loop legs' lengths (cut from 5, 3 and 3 s when phases train and
# tools joined, then from 3, 2 and 2 s when a slow host ran the script past
# its time limit, to keep the run well inside it)
SERVE_SECONDS = 2.0   # each closed-loop leg of /search_vector
TEXT_SECONDS = 1.0    # each closed-loop leg of /search?q=
INPROC_SECONDS = 1.0  # each leg of SearchService.search without HTTP
SERVE_CLIENTS = (1, 16)
SERVE_IMAGES = 8      # /encode_image's batch: the bucket-8 chunk
SERVE_APPEND = 1024   # rows /reload's incremental leg appends
SERVE_TEXTS = [f"a photo of {w}" for w in (
    "a cat", "two dogs", "a red car", "the sea", "a mountain", "a city",
    "a bird", "a bowl of fruit", "a forest", "snow", "a bicycle", "a boat",
    "a child", "the moon", "a guitar", "a bridge")]
# the attention kernels' plain versions and the PQ scan's: each raises in
# phase serve, so every request on the card runs the kernels
ATTN_PLAINS = ("fused_attn_block_plain", "sdpa_plain", "packed_sdpa_qkv_plain",
               "fused_sdpa_long_plain", "fused_sdpa_long_qkv_plain",
               "fused_attn_sublayer_plain")

# the closed-loop load: a separate process (stdlib only), so the clients'
# Python does not share the service's interpreter lock. Argument: a JSON
# spec file {port, clients, seconds, requests: [[method, path, body]]};
# client c sends requests c, c + clients, ... in turn, one connection a
# request (the service speaks HTTP/1.0). Prints one JSON line: request
# count, wall, latencies' p50 and p99, non-200 answers, and for each
# request index the distinct result lists it got.
_LOADGEN = r"""
import json, sys, threading, time
from http.client import HTTPConnection

spec = json.load(open(sys.argv[1]))
reqs, n_clients = spec["requests"], spec["clients"]
lock = threading.Lock()
lat, bad, seen = [], [], {}
go = threading.Barrier(n_clients + 1)
end = [0.0]

def client(c):
    i, mine = c, []
    go.wait()
    while time.perf_counter() < end[0]:
        method, path, body = reqs[i % len(reqs)]
        t0 = time.perf_counter()
        conn = HTTPConnection("127.0.0.1", spec["port"], timeout=300)
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        mine.append(time.perf_counter() - t0)
        with lock:
            if resp.status != 200:
                bad.append([i % len(reqs), resp.status, data.decode()[:200]])
            else:
                rows = json.dumps(json.loads(data)["results"])
                seen.setdefault(str(i % len(reqs)), set()).add(rows)
        i += n_clients
    with lock:
        lat.extend(mine)

threads = [threading.Thread(target=client, args=(c,))
           for c in range(n_clients)]
for t in threads:
    t.start()
t0 = time.perf_counter()
end[0] = t0 + spec["seconds"]
go.wait()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
lat.sort()
print(json.dumps({
    "requests": len(lat), "wall_s": wall, "qps": len(lat) / wall,
    "p50_ms": lat[len(lat) // 2] * 1e3,
    "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
    "bad": bad[:5], "n_bad": len(bad),
    "responses": {k: [json.loads(r) for r in v] for k, v in seen.items()}}))
"""


def _http(port, method, path, payload=None):
    """(status, JSON, seconds) of one request."""
    from http.client import HTTPConnection

    body = None if payload is None else json.dumps(payload)
    t0 = time.perf_counter()
    conn = HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data, time.perf_counter() - t0


def _load(port, requests, clients, seconds, tmp) -> dict:
    """The closed-loop load of _LOADGEN; fails on any non-200 answer."""
    spec = os.path.join(tmp, "load.json")
    with open(spec, "w") as f:
        json.dump({"port": port, "clients": clients, "seconds": seconds,
                   "requests": requests}, f)
    out = subprocess.run([sys.executable, "-c", _LOADGEN, spec],
                         capture_output=True, text=True,
                         timeout=seconds + 300)
    check(out.returncode == 0, f"load client failed: {out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    check(res["n_bad"] == 0 and res["requests"] > 0,
          f"load at {clients} clients: {res['n_bad']} non-200 answers, "
          f"first {res['bad']}")
    return res


def _rows_of(results, k):
    """A response's result rows as (D, I) arrays of one query."""
    check(len(results) == k, f"a response held {len(results)} rows, not {k}")
    return (np.array([[r["score"] for r in results]], np.float32),
            np.array([[r["id"] for r in results]], np.int64))


class _ServeRun:
    """clipx_torch.serve.make_server over args on a thread of this
    process, with its boot and warm-up seconds."""

    def __init__(self, argv, enc):
        import threading

        from clipx_torch import serve as tserve

        t0 = time.perf_counter()
        self.server = tserve.make_server(tserve.build_parser().parse_args(
            argv), encoder=enc)
        self.boot_s = time.perf_counter() - t0
        self.service = self.server.RequestHandlerClass.service
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        t0 = time.perf_counter()
        while not self.get("/healthz")[1].get("warm"):
            check(time.perf_counter() - t0 < 600, "serve never got warm")
            time.sleep(0.05)
        self.warm_s = time.perf_counter() - t0

    def get(self, path):
        return _http(self.port, "GET", path)

    def post(self, path, payload):
        return _http(self.port, "POST", path, payload)

    def metrics(self) -> dict:
        return self.get("/metrics")[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.server._warmup_stop.set()
        self.server._warmup_thread.join(timeout=600)
        self.service.close()
        self.service.env.close()
        del self.service, self.server
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def _in_process_legs(run, queries, threads=SERVE_CLIENTS) -> dict:
    """Where a /search_vector's time goes, without HTTP: p50 of a direct
    index.search (Q = 1) and of the k store lookups of one answer, then
    SearchService.search (coalescer, search, lookups) closed loop from
    threads of this process for INPROC_SECONDS at each thread count."""
    import threading

    service = run.service
    index = service.current_index()
    out = {"index_search_p50_ms": _search_p50(index, queries[:1], K)[2]}
    times = []
    for i in range(30):
        t0 = time.perf_counter()
        for j in range(K):
            service.lookup_path(i * K + j)
        times.append(time.perf_counter() - t0)
    out["k_lookups_p50_ms"] = statistics.median(times) * 1e3
    for n in threads:
        lat, end = [[] for _ in range(n)], time.perf_counter() + INPROC_SECONDS

        def loop(c):
            i = c
            while time.perf_counter() < end:
                t0 = time.perf_counter()
                service.search(queries[i % len(queries)][None], K)
                lat[c].append(time.perf_counter() - t0)
                i += n

        workers = [threading.Thread(target=loop, args=(c,))
                   for c in range(n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        done = sorted(t for per in lat for t in per)
        out[f"threads_{n}"] = {"calls": len(done),
                               "per_s": len(done) / INPROC_SECONDS,
                               "p50_ms": done[len(done) // 2] * 1e3}
    return out


def _vector_legs(run, queries, tmp, clients=SERVE_CLIENTS) -> dict:
    """/search_vector of the 16 queries, closed loop at each client count:
    every answer equal to a direct Q = 1 search of the served index (ids;
    scores within 1e-5, TIE-close runs as sets)."""
    index = run.service.current_index()
    direct = [index.search(q[None], K) for q in queries]
    requests = [["POST", "/search_vector",
                 json.dumps({"vector": q.tolist(), "k": K})]
                for q in queries]
    out = {}
    for n in clients:
        before = run.metrics()["coalesce"]
        res = _load(run.port, requests, n, SERVE_SECONDS, tmp)
        after = run.metrics()["coalesce"]
        for i, answers in res.pop("responses").items():
            De, Ie = direct[int(i)]
            for rows in answers:
                D, I = _rows_of(rows, K)
                check(_same_ranking(D, I, De, Ie),
                      f"/search_vector at {n} clients: query {i} differs "
                      "from a direct search")
        out[f"clients_{n}"] = {**res, "coalesce_batches":
                               after["batches"] - before["batches"],
                               "coalesce_queries":
                               after["queries"] - before["queries"]}
    return out


def _text_legs(run, enc, tmp) -> dict:
    """/search?q= of 16 texts at 1 and 16 clients: every answer equal (the
    1e-4 rule of tests/test_torch_cli.py) to a direct search of the text's
    embedding at the bucket its coalesced batch took (1, 4 or 16)."""
    index = run.service.current_index()
    direct = {}
    for i, t in enumerate(SERVE_TEXTS):
        direct[i] = [index.search(enc.encode_texts([t] * b)[:1], K)
                     for b in (1, 4, 16)]
    requests = [["GET", "/search?q=" + t.replace(" ", "+") + f"&k={K}", None]
                for t in SERVE_TEXTS]
    out = {}
    for n in SERVE_CLIENTS:
        before = run.metrics()["text_coalesce"]
        res = _load(run.port, requests, n, TEXT_SECONDS, tmp)
        after = run.metrics()["text_coalesce"]
        for i, answers in res.pop("responses").items():
            for rows in answers:
                D, I = _rows_of(rows, K)
                check(any(_same_ranking(D, I, De, Ie, atol=1e-4, tie=1e-4)
                          for De, Ie in direct[int(i)]),
                      f"/search?q= at {n} clients: text {i} differs from a "
                      "direct search at every text bucket")
        out[f"clients_{n}"] = {**res, "text_coalesce_batches":
                               after["batches"] - before["batches"],
                               "text_coalesce_queries":
                               after["queries"] - before["queries"]}
    return out


def _image_requests(run, enc, pngs) -> dict:
    """/search_image of one image (B2 at bucket 1, nothing else) and
    /encode_image of it and of 8 (B1 at bucket 8, nothing else), each
    embedding bitwise enc.encode_images of the same decoded pixels."""
    import base64

    from clipx_torch.data.pipeline import decode_bytes_rgb

    layers = enc.cfg.vision.layers
    b64 = [base64.b64encode(p).decode() for p in pngs]
    pixels = np.stack([decode_bytes_rgb(np.frombuffer(p, np.uint8),
                                        enc.image_size) for p in pngs])
    out = {}
    for name, path, payload, want, n in (
            ("search_image", "/search_image", {"image_b64": b64[0],
                                               "k": K}, "packed_sdpa", 1),
            ("encode_image_1", "/encode_image", {"images_b64": b64[:1]},
             "packed_sdpa", 1),
            ("encode_image_8", "/encode_image", {"images_b64": b64},
             "fused_attn_block", SERVE_IMAGES)):
        before = kernel_counts()
        status, data, secs = run.post(path, payload)
        counts = {k: c - before[k] for k, c in kernel_counts().items()
                  if c != before[k]}
        check(status == 200, f"{path}: {status} {data}")
        check(counts == {want: layers}, f"{path} of {n} image(s) launched "
              f"{counts}, expected {want} once a layer ({layers})")
        direct = enc.encode_images(pixels[:n])
        if name == "search_image":
            De, Ie = run.service.current_index().search(direct, K)
            D, I = _rows_of(data["results"], K)
            check(_same_ranking(D, I, De, Ie), "/search_image differs from "
                  "a direct search of the encoded pixels")
        else:
            check(np.array_equal(np.asarray(data["embeddings"], np.float32),
                                 direct), f"{path} of {n}: embeddings are "
                  "not bitwise enc.encode_images of the decoded pixels")
        out[name] = {"ms": secs * 1e3, "launches": counts}
    return out


def _write_sidecar(path, rows) -> bytes:
    from clipx_torch.search.engine import IndexWriter

    writer = IndexWriter(path, *rows.shape)
    for i in range(0, rows.shape[0], 1 << 18):
        writer.write(rows[i: i + (1 << 18)])
    writer.close()
    return writer.content_hash


def _put_paths(db_path, paths: dict, vectors: dict = None) -> None:
    """idx_db id -> path, and fn_db path -> vector, written through an
    environment of their own (the service sees them after a refresh)."""
    from clipx_torch.store.kv import open_env

    env = open_env(db_path)
    idx_db, fn_db = env.open_db(b"idx_db"), env.open_db(b"fn_db")
    with env.begin(db=idx_db, write=True) as txn:
        for i, p in paths.items():
            txn.put(f"{i}".encode(), p.encode())
    with env.begin(db=fn_db, write=True) as txn:
        for p, v in (vectors or {}).items():
            txn.put(p.encode(), np.ascontiguousarray(v, np.float32
                                                     ).tobytes())
    env.close()


def _row_path(i: int) -> str:
    n = CORPUS_ROWS
    return (f"rows/r{i:07d}.jpg" if i < n else
            f"img/img{i - n:05d}.png" if i < n + N_IMAGES else
            f"new/n{i:07d}.jpg")


def _index_bytes(idx) -> int:
    return sum(t.numel() * t.element_size()
               for t in (idx._corpus, idx._codes, idx._scales)
               if t is not None)


def _serve_reload(run, rows, db, sidecar) -> dict:
    """/reload twice on the running service: SERVE_APPEND rows appended to
    the sidecar (incremental; a new id answers /similar through the
    refreshed store), then the first SERVE_APPEND rows rewritten
    (rebuild), with the allocator's peak over the rebuild in corpora."""
    n = rows.shape[0]
    rng = np.random.default_rng(SEED + 1)
    new = rng.standard_normal((SERVE_APPEND, DIM), dtype=np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    grown = np.concatenate([rows, new])
    _write_sidecar(sidecar, grown)
    probe = n + 5
    _put_paths(db, {i: _row_path(i) for i in range(n, n + SERVE_APPEND)},
               {_row_path(probe): new[5]})
    t0 = time.perf_counter()
    status, r, _ = run.post("/reload", {})
    inc_s = time.perf_counter() - t0
    check(status == 200 and r == {"ntotal": n + SERVE_APPEND,
                                  "previous_ntotal": n,
                                  "mode": "incremental"},
          f"/reload after an append: {status} {r}")
    status, sim, _ = run.get(f"/similar?id={probe}&k={K}")
    check(status == 200 and sim["results"][0]["id"] == probe,
          "an appended row did not find itself first after /reload")

    grown[:SERVE_APPEND] = rng.standard_normal((SERVE_APPEND, DIM),
                                               dtype=np.float32)
    grown[:SERVE_APPEND] /= np.linalg.norm(grown[:SERVE_APPEND], axis=1,
                                           keepdims=True)
    _write_sidecar(sidecar, grown)
    torch.cuda.synchronize()
    old_bytes = _index_bytes(run.service.index)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    status, r, _ = run.post("/reload", {})
    rebuild_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(status == 200 and r == {"ntotal": n + SERVE_APPEND,
                                  "previous_ntotal": n + SERVE_APPEND,
                                  "mode": "rebuild"},
          f"/reload after a rewrite: {status} {r}")
    corpus = run.service.index._corpus
    corpus_bytes = corpus.numel() * corpus.element_size()
    after = torch.cuda.memory_allocated()
    status, res, _ = run.post("/search_vector", {"vector":
                                                 grown[7].tolist(), "k": K})
    check(status == 200 and res["results"][0]["id"] == 7,
          "a rewritten row did not find itself first after the rebuild")
    gib = 2 ** 30
    return {"incremental_s": inc_s, "rebuild_s": rebuild_s,
            "ntotal": n + SERVE_APPEND, "corpus_gib": corpus_bytes / gib,
            "allocated_before_gib": before / gib,
            "old_index_gib": old_bytes / gib,
            "rebuild_peak_gib": peak / gib,
            "allocated_after_gib": after / gib,
            "rebuild_peak_in_corpora": peak / corpus_bytes,
            "rebuild_peak_over_the_rest_in_corpora":
            (peak - (before - old_bytes)) / corpus_bytes}


def _cold_start(argv, tmp, texts_p50, vector_p50, image_ms) -> dict:
    """python -m clipx_torch.serve --no-warmup in a process of its own on
    the same files: seconds to the first /healthz 200, then the first
    request of each family against phase serve's warm numbers, then
    SIGTERM (exit 0, 'bye')."""
    import base64
    import select

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log = open(os.path.join(tmp, "cold.err"), "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "clipx_torch.serve", "--no-warmup",
         *argv], cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=log,
        text=True)
    try:
        port, out = None, ""
        while port is None:
            check(time.perf_counter() - t0 < 600 and proc.poll() is None,
                  f"cold serve did not start: {out}")
            if select.select([proc.stdout], [], [], 1.0)[0]:
                out += proc.stdout.readline()
                m = re.search(r"clipx-serve on http://[^:]+:(\d+)", out)
                port = int(m.group(1)) if m else None
        while True:
            try:
                if _http(port, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < 600, "cold serve never healthy")
            time.sleep(0.02)
        healthy_s = time.perf_counter() - t0
        first = {}
        q = np.random.default_rng(SEED).standard_normal(DIM).astype(
            np.float32)
        png = _png(np.full((224, 224, 3), 127, np.uint8))
        for family, method, path, payload in (
                ("search", "POST", "/search_vector",
                 {"vector": (q / np.linalg.norm(q)).tolist(), "k": K}),
                ("text", "GET", "/search?q=a+photo+of+a+dog&k=50", None),
                ("image", "POST", "/search_image",
                 {"image_b64": base64.b64encode(png).decode(), "k": K})):
            ms = []
            for _ in range(2):
                status, data, secs = _http(port, method, path, payload)
                check(status == 200, f"cold {family}: {status} {data}")
                ms.append(secs * 1e3)
            first[family] = {"first_ms": ms[0], "second_ms": ms[1]}
        first["search"]["warm_p50_ms"] = vector_p50
        first["text"]["warm_p50_ms"] = texts_p50
        first["image"]["warm_ms"] = image_ms
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=300)
        check(proc.returncode == 0 and "bye" in rest,
              f"cold serve's SIGTERM exit: {proc.returncode} {rest}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log.close()
    return {"healthz_200_s": healthy_s, "families": first}


def _png(rgb: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".png", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    check(ok, "cv2 could not encode a PNG")
    return buf.tobytes()


def phase_serve(enc, search: dict, images: np.ndarray, card: str) -> dict:
    """The port's HTTP service at ViT-B/32 on phase search's corpus, on the
    card, in this process on 127.0.0.1 (port 0), with phase encode's
    encoder and the clients in a process of their own. Every part runs with
    the attention kernels' and the PQ scan's plain versions refused; launch
    counts are set to 0 before each part and read after it. One line a
    part:

    1. default flags (--search-mode auto: quant at 1M rows): warm-up
       seconds; /search_vector and /search?q= closed loop at 1 and 16
       clients, every answer against a direct search; the same searches
       through SearchService.search without HTTP; /similar of encoded ids;
       /search_image (B2 only) and /encode_image of 1 and 8 (B1 only),
       embeddings bitwise; no request launches B3-B10; then /reload
       incremental (an append) and rebuild (a rewrite), with the
       rebuild's allocator peak in corpora;
    2. --corpus-dtype pq booted from phase coded's pq codes: B11 once a
       search batch, answers against a direct search;
    3. CLIPX_SERVE_COALESCE=0 at 16 clients, over HTTP and without;
    4. --sharded on (phase sharded's service leg): one /search_vector
       answer equal to part 1's;
    5. a cold start without warm-up in a process of its own."""
    from clipx_torch.ops import flash_attention as tfa
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.ops import pq_scan as pqs
    from clipx_torch.search import codes_io
    from clipx_torch.search.engine import corpus_rotation
    from clipx_torch.search.pq import PQCodebook
    from clipx_torch.utils.env import restoring

    rows, queries = search["rows"], search["queries"]
    n = rows.shape[0]
    plains = ([(ps, name) for name in ATTN_PLAINS]
              + [(tfa, "flash_attention_plain"),
                 (pqs, "pq_scan_scores_plain")])
    parts, launches = {}, []

    def part(name, fn, *args):
        ps.reset_launches()
        with _refuse_plain("HTTP service", plains):
            info = fn(*args)
        counts = kernel_counts()
        launches.append(counts)
        info = {"phase": "serve", "part": name, "card": card, **info,
                "launches": {k: c for k, c in counts.items() if c}}
        emit(info)
        parts[name] = info
        return counts

    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "vectors.lmdb")
        os.makedirs(db)
        sidecar = os.path.join(tmp, "images.index")
        orig = os.path.join(tmp, "orig.index")
        t0 = time.perf_counter()
        content_hash = _write_sidecar(sidecar, rows)
        os.link(sidecar, orig)
        _put_paths(db, {i: _row_path(i) for i in range(n)},
                   {_row_path(CORPUS_ROWS + j): rows[CORPUS_ROWS + j]
                    for j in range(N_IMAGES)})
        setup_s = time.perf_counter() - t0
        argv = ["--model", "ViT-B/32", "--db", db, "--port", "0"]
        pngs = [_png(im) for im in images[:SERVE_IMAGES]]
        vector_0 = {"vector": queries[0].tolist(), "k": K}
        answers = {}

        def default():
            run = _ServeRun(argv + ["--index", sidecar], enc)
            try:
                check(run.service.index.quantized,
                      "--search-mode auto did not pick quant at 1M rows")
                out = {"setup_s": setup_s, "boot_s": run.boot_s,
                       "warmup_s": run.warm_s,
                       "search_vector": _vector_legs(run, queries, tmp),
                       "search_text": _text_legs(run, enc, tmp),
                       "in_process": _in_process_legs(run, queries)}
                for j in range(4):
                    i = CORPUS_ROWS + j
                    status, sim, _ = run.get(f"/similar?id={i}&k={K}")
                    check(status == 200 and sim["results"][0]["id"] == i,
                          f"/similar?id={i}: rank 0 is not the id itself")
                # the answer part "sharded" must give too
                status, answer, _ = run.post("/search_vector", vector_0)
                check(status == 200, "/search_vector of query 0 failed")
                answers["default"] = _rows_of(answer["results"], K)
                out.update(_image_requests(run, enc, pngs))
                part_counts = kernel_counts()
                check(not any(c for name, c in part_counts.items()
                              if name not in ("fused_attn_block",
                                              "packed_sdpa")),
                      f"phase serve's default requests launched a kernel "
                      f"other than B1 and B2: {part_counts}")
                out["reload"] = _serve_reload(run, rows, db, sidecar)
                return out
            finally:
                run.close()

        part("default", default)

        def coded():
            payload = dict(search["payloads"]["pq"])
            payload["codebook"] = PQCodebook(payload["centroids"])
            if payload["rot_matrix"] is None and payload["rotated"]:
                # a file without a trained rotation used the fixed one
                payload["rot_matrix"] = corpus_rotation(DIM)
            t1 = time.perf_counter()
            codes_io.write_payload_file(orig, payload, tier="pq",
                                        content_hash=content_hash)
            write_s = time.perf_counter() - t1
            written = os.stat(codes_io.codes_path(orig)).st_mtime_ns
            run = _ServeRun(argv + ["--index", orig, "--corpus-dtype", "pq"],
                            enc)
            try:
                check(run.service.index.pq_storage
                      and run.metrics()["index"]["booted_from_codes"]
                      and os.stat(codes_io.codes_path(orig)).st_mtime_ns
                      == written, "pq serve did not boot from the codes file")
                before = ps.launch_counts()["pq_scan_scores"]
                legs = _vector_legs(run, queries, tmp)
                b11 = ps.launch_counts()["pq_scan_scores"] - before
                batches = sum(leg["coalesce_batches"]
                              for leg in legs.values())
                # the direct searches of the check: one launch each
                check(b11 == batches + len(queries),
                      f"pq serve launched B11 {b11} times for {batches} "
                      f"search batches and {len(queries)} direct searches")
                return {"codes_write_s": write_s, "boot_s": run.boot_s,
                        "warmup_s": run.warm_s, "search_vector": legs,
                        "b11_launches_in_legs": b11}
            finally:
                run.close()

        part("pq", coded)

        def coalesce_off():
            with restoring(CLIPX_SERVE_COALESCE="0"):
                run = _ServeRun(argv + ["--index", orig], enc)
            try:
                check(run.service._search_co is None, "coalescer not off")
                return {"boot_s": run.boot_s, "warmup_s": run.warm_s,
                        "search_vector": _vector_legs(run, queries, tmp,
                                                      clients=(16,)),
                        "in_process": _in_process_legs(run, queries,
                                                       threads=(16,))}
            finally:
                run.close()

        part("coalesce_off", coalesce_off)

        def sharded():
            # phase sharded's service leg, on this phase's deployment:
            # --sharded on row-shards the index over every visible GPU
            run = _ServeRun(argv + ["--index", orig, "--sharded", "on"], enc)
            try:
                index = run.service.current_index()
                check(type(index).__name__ == "ShardedVectorIndex"
                      and index.quantized and index.ntotal == n,
                      "--sharded on did not serve a quant ShardedVectorIndex")
                status, answer, secs = run.post("/search_vector", vector_0)
                check(status == 200, "sharded /search_vector failed")
                D, I = _rows_of(answer["results"], K)
                Dd, Id = answers["default"]
                check(_same_ranking(D, I, Dd, Id), "the sharded service's "
                      "/search_vector answer differs from the default's")
                return {"boot_s": run.boot_s, "warmup_s": run.warm_s,
                        "shards": index.n_shards, "request_s": secs,
                        "ids_identical_to_default": bool(
                            np.array_equal(I, Id)),
                        "max_abs_score_diff": float(np.abs(D - Dd).max())}
            finally:
                run.close()

        part("sharded", sharded)
        default_info = parts["default"]
        parts["cold"] = {"phase": "serve", "part": "cold", "card": card,
                         **_cold_start(
                             argv + ["--index", orig], tmp,
                             default_info["search_text"]["clients_1"][
                                 "p50_ms"],
                             default_info["search_vector"]["clients_1"][
                                 "p50_ms"],
                             default_info["search_image"]["ms"])}
        emit(parts["cold"])
    total = {name: sum(c[name] for c in launches) for name in launches[0]}
    return {"parts": parts, "launches": total}


# ---------------------------------------------------------------------------
# phase: corpus-sharded search and the data-parallel encode (clipx_torch/
# parallel)
# ---------------------------------------------------------------------------

SHARDS = 4           # shards of the one-card mesh: cuda:0 listed 4 times
SHARD_REPS = 10      # timed searches a p50 (after 3 warm-ups)
GROW_SHARE = 100     # the growth leg appends the last 1/GROW_SHARE of rows
RECALL_SLACK = 0.02  # a coded tier's sharded recall@50 may trail its
# single-device recall by this much (its candidate pool is a superset; ties
# may fall either way)


def _sharded_tier(name, idx, queries, exact_ids, picks, total, ref) -> dict:
    """One sharded tier: p50 at Q = 16, the _tier_checks and recall@50
    against the single-device index's ids of the same tier (``ref``)."""
    D, I, p50 = _search_p50(idx, queries, K, reps=SHARD_REPS)
    out = {"p50_ms": p50, **_tier_checks(name, D, I, exact_ids, picks,
                                         total)}
    if ref is not None:
        Dr, Ir = ref
        out["recall_at_50_vs_single"] = float(np.mean(
            [len(set(a) & set(b)) / K for a, b in zip(I, Ir)]))
        out["ids_identical_to_single"] = bool(np.array_equal(I, Ir))
        out["scores_bitwise_single"] = bool(np.array_equal(D, Dr))
    return out, (D, I)


def _flat_legs(mesh, search: dict, tiers) -> dict:
    """ShardedVectorIndex on ``mesh`` for each of ``tiers``: f32 exact, bf16
    and quant from the host rows, int8, int4 and pq from phase coded's
    codes payloads (no re-encode). Exact f32 and bf16 must give the
    single-device ids; quant phase search's exact ids but for the
    near-duplicate exception; the coded tiers find the perturbed rows first
    and keep their single-device recall@50 against exact (within
    RECALL_SLACK)."""
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.parallel.mips import ShardedVectorIndex
    from clipx_torch.search.engine import VectorIndex

    rows, queries = search["rows"], search["queries"]
    exact_ids, picks = search["ids"], search["picks"]
    total = rows.shape[0]
    single = dict(search["tier_results"], f32=(search["scores"], exact_ids),
                  quant=(search["quant_scores"], search["quant_ids"]))
    out = {}
    for tier in tiers:
        if tier == "bf16":
            # phase coded's bf16 index ran quant (auto at 1M rows): the
            # exact bf16 reference on one device
            ref = VectorIndex(DIM, device=mesh.devices[0], dtype="bf16")
            ref.add(rows)
            single["bf16"] = ref.search(queries, K)
            del ref
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if tier in ("int8", "int4", "pq"):
            idx = ShardedVectorIndex.from_codes(search["payloads"][tier],
                                                mesh)
        else:
            idx = ShardedVectorIndex(rows, mesh,
                                     dtype="bf16" if tier == "bf16" else "f32",
                                     quantized=tier == "quant")
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        if tier == "pq":
            before = ps.launch_counts()["pq_scan_scores"]
            idx.search(queries, K)
            b11 = ps.launch_counts()["pq_scan_scores"] - before
            check(b11 == idx.n_shards, f"sharded pq launched B11 {b11} times "
                  f"a search, expected one a shard ({idx.n_shards})")
        info, (D, I) = _sharded_tier(tier, idx, queries, exact_ids, picks,
                                     total, single[tier])
        info["place_s"] = place_s
        if tier == "pq":
            info["b11_launches_per_search"] = b11
        if tier in ("f32", "bf16"):
            check(info["ids_identical_to_single"],
                  f"sharded {tier} ids differ from the single-device index's")
            info["max_abs_score_diff"] = float(np.abs(D - single[tier][0]
                                                      ).max())
        elif tier == "quant":
            same = (I == exact_ids).all(axis=1)
            exc = ((I[:, 0] == exact_ids[:, 0])
                   & (np.abs(D - search["scores"]) <= NEAR_DUP_ATOL
                      ).all(axis=1))
            check(bool((same | exc).all()), "sharded quant ids differ from "
                  "exact beyond the near-duplicate exception")
            info["rows_identical_to_exact"] = int(same.sum())
        else:
            r1 = float(np.mean([len(set(a) & set(b)) / K for a, b in
                                zip(single[tier][1], exact_ids)]))
            info["single_recall_at_50"] = r1
            check(info["recall_at_50"] >= r1 - RECALL_SLACK,
                  f"sharded {tier} recall@50 {info['recall_at_50']} trails "
                  f"the single-device {r1}")
        out[tier] = info
        if tier == "f32":
            out["_f32"] = (D, I)
        del idx
        torch.cuda.empty_cache()
    return out


def _ivf_legs(mesh, search: dict, device) -> dict:
    """ShardedIVFIndex on phase ivf's .ivf layouts: f32 (unquantized) over
    the whole corpus, its nprobe-100 ranking against phase ivf's IVFIndex
    (ids identical, scores within 1e-5, bitwise reported); residual pq
    installed from phase ivf's stashed codes (no encode), B11 once per
    (shard, query, probed chunk). Recall@50 and p50 at nprobe 32 and
    100."""
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.search import ivf as tivf

    rows, queries = search["rows"], search["queries"]
    res = search["ivf_residual"]
    out = {}
    for tier in ("f32", "pq_residual"):
        t0 = time.perf_counter()
        if tier == "f32":
            idx = tivf.ShardedIVFIndex.from_vectors(
                rows, cache_path=search["ivf_cache"], mesh=mesh)
            ref_ids = search["ids"]
        else:
            idx = tivf.ShardedIVFIndex.from_codes(res["payload"],
                                                  res["cache"], mesh=mesh)
            ref_ids = res["ids"]
        torch.cuda.synchronize()
        check(idx is not None, f"sharded IVF {tier}: the .ivf did not load")
        r = {"install_s": time.perf_counter() - t0, "segments": idx._segs()}
        s_loc = idx._segs() // idx._n_shards
        for nprobe in (32, 100):
            before = ps.launch_counts()["pq_scan_scores"]
            D, I = idx.search(queries, K, nprobe=nprobe)
            b11 = ps.launch_counts()["pq_scan_scores"] - before
            if tier == "pq_residual":
                P = idx.probe_bucket(K, nprobe)
                p_loc = min(tivf._bucket_probe(-(-P // idx._n_shards)),
                            s_loc)
                want = (idx._n_shards * NQ
                        * -(-p_loc // tivf._pq_chunk_segs(p_loc, 64)))
                check(b11 == want, f"sharded IVF-PQ nprobe {nprobe}: B11 "
                      f"launched {b11} times, expected {want}")
                r[f"b11_launches_nprobe{nprobe}"] = b11
            check(I.shape == (NQ, K) and bool((I >= 0).all())
                  and bool((np.diff(D, axis=1) <= 0).all()),
                  f"sharded IVF {tier} nprobe {nprobe}: bad results")
            _, _, p50 = _search_p50(
                _NProbe(idx, nprobe), queries, K, reps=SHARD_REPS)
            r[f"nprobe{nprobe}"] = {"p50_ms": p50, "recall_at_50": float(
                np.mean([len(set(a) & set(b)) / K
                         for a, b in zip(I, ref_ids)]))}
        if tier == "f32":
            Dv, Iv = search["ivf_full"]
            check(_same_ranking(D, I, Dv, Iv),
                  "sharded f32 IVF at nprobe 100 differs from IVFIndex's")
            r["ids_identical_to_ivfindex"] = bool(np.array_equal(I, Iv))
            r["bitwise_ivfindex"] = bool(np.array_equal(I, Iv)
                                         and np.array_equal(D, Dv))
            r["max_abs_score_diff"] = float(np.abs(D - Dv).max())
        out[tier] = r
        del idx
        torch.cuda.empty_cache()
    return out


class _NProbe:
    """An IVF index whose search takes a fixed nprobe (for _search_p50)."""

    def __init__(self, idx, nprobe):
        self.idx, self.nprobe = idx, nprobe

    def search(self, queries, k):
        return self.idx.search(queries, k, nprobe=self.nprobe)


def _grow_leg(mesh, search: dict, fresh) -> dict:
    """A sharded f32 index of all but the last 1/GROW_SHARE of the rows,
    then add() of that delta: the growth re-deals the rows into larger
    shards on the card; ids continue from ntotal (the 8 encoded images,
    in the delta, are found there) and results equal the fresh build's
    (``fresh``: _flat_legs' f32 (D, I)) over the same rows."""
    from clipx_torch.parallel.mips import ShardedVectorIndex

    rows, queries = search["rows"], search["queries"]
    n0 = rows.shape[0] - rows.shape[0] // GROW_SHARE
    Df, If = fresh
    t0 = time.perf_counter()
    idx = ShardedVectorIndex(rows[:n0], mesh)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    rows_before = idx._rows
    t0 = time.perf_counter()
    idx.add(rows[n0:])
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    check(idx.ntotal == rows.shape[0] and idx._rows > rows_before,
          "the sharded add did not grow the shards")
    D, I = idx.search(queries, K)
    # the encoded images (queries 0-7 are their rows) lie in the delta
    check(bool((I[: NQ // 2, 0] >= n0).all()),
          "appended rows did not continue the ids")
    check(_same_ranking(D, I, Df, If),
          "the grown sharded index differs from the fresh build")
    return {"base_rows": n0, "delta_rows": rows.shape[0] - n0,
            "place_s": place_s, "add_s": add_s,
            "rows_per_shard_before": rows_before,
            "rows_per_shard_after": idx._rows,
            "ids_identical_to_fresh": bool(np.array_equal(I, If)),
            "bitwise_fresh": bool(np.array_equal(I, If)
                                  and np.array_equal(D, Df))}


def _dp_encode_leg(device, images: np.ndarray, embs: np.ndarray) -> dict:
    """ViT-B/32 over a "dp" mesh of cuda:0 twice, 1,024 images at batch 128:
    two even shares of 64 a batch, B1 once a layer a share; against phase
    encode's embeddings of the same images (cosine >= COS_MIN; bitwise
    reported)."""
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.parallel.mesh import make_mesh
    from clipx_torch.runtime.encoder import Encoder

    t0 = time.perf_counter()
    enc = Encoder.create("ViT-B/32", seed=SEED,
                         mesh=make_mesh({"dp": 2}, [device] * 2))
    enc.warmup(buckets=(BATCH,))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = ps.launch_counts()["fused_attn_block"]
    t0 = time.perf_counter()
    out = np.concatenate([enc.encode_images(images[i: i + BATCH])
                          for i in range(0, N_IMAGES, BATCH)])
    secs = time.perf_counter() - t0
    b1 = ps.launch_counts()["fused_attn_block"] - before
    layers = enc.cfg.vision.layers
    check(b1 == 2 * layers * (N_IMAGES // BATCH),
          f"the dp encode launched B1 {b1} times, expected {2 * layers} a "
          "batch (once a layer a share)")
    cos = (out * embs).sum(axis=1)
    check(bool((cos >= COS_MIN).all()), f"dp encode vs phase encode cosine "
          f"{float(cos.min())}")
    return {"mesh": {"dp": 2}, "images": N_IMAGES, "batch": BATCH,
            "setup_s": setup_s, "seconds": secs,
            "img_per_s": N_IMAGES / secs, "b1_launches_per_batch":
            b1 / (N_IMAGES // BATCH), "cos_min": float(cos.min()),
            "cos_tolerance": COS_MIN,
            "max_abs_diff": float(np.abs(out - embs).max()),
            "bitwise": bool(np.array_equal(out, embs))}


def _process_leg(device, search: dict) -> dict:
    """One search through distributed.initialize with a single NCCL rank:
    the mesh from global_devices spans the process group, so the merge
    runs all_gather over NCCL; the group is destroyed after."""
    import socket

    import torch.distributed as dist

    from clipx_torch.parallel import distributed
    from clipx_torch.parallel.mesh import make_mesh
    from clipx_torch.parallel.mips import ShardedVectorIndex

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rows, queries = search["rows"], search["queries"]
    sub = rows[-(1 << 17):]  # the last 131,072 rows, the images among them
    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{port}", num_processes=1,
                           process_id=0, device=str(device))
    try:
        init_s = time.perf_counter() - t0
        backend = "nccl" if device.type == "cuda" else "gloo"
        check(dist.get_backend() == backend, f"the group is not {backend}")
        devices, ranks = distributed.global_devices([device] * SHARDS)
        mesh = make_mesh({"shard": SHARDS}, devices, ranks)
        check(mesh.process_group, "the mesh does not span the group")
        D, I = ShardedVectorIndex(sub, mesh).search(queries, K)
    finally:
        distributed.shutdown()
    check(not dist.is_initialized(), "the process group was not destroyed")
    ref = ShardedVectorIndex(sub, make_mesh({"shard": SHARDS},
                                            [device] * SHARDS))
    Dr, Ir = ref.search(queries, K)
    check(np.array_equal(I, Ir) and np.array_equal(D, Dr),
          "the NCCL-gathered search differs from the in-process one")
    return {"backend": backend, "ranks": 1, "rows": sub.shape[0],
            "init_s": init_s, "identical_to_in_process": True}


def phase_sharded(device, search: dict, images: np.ndarray,
                  embs: np.ndarray) -> dict:
    """Corpus-sharded search and the dp encode (clipx_torch/parallel), on a
    "shard" mesh of SHARDS positions all on cuda:0 (one card serves every
    shard: these are not multi-GPU numbers), and, with more than one GPU
    visible, f32 and pq again over every GPU. Legs: the flat tiers on phase
    search's corpus (_flat_legs), IVF on phase ivf's layouts (_ivf_legs),
    growth (_grow_leg), the dp encode (_dp_encode_leg), one NCCL rank
    (_process_leg); then B11 against its plain version, bitwise, on one
    shard's codes. Returns the info and this path's launch counts, read
    before that check."""
    from clipx_torch.ops import pq_scan as pqs
    from clipx_torch.parallel.mesh import make_mesh, visible_devices
    from clipx_torch.parallel.mips import ShardedVectorIndex, shard_mesh
    from clipx_torch.search import pq as pq_lib
    from clipx_torch.search.engine import rotate_rows

    mesh = make_mesh({"shard": SHARDS}, [device] * SHARDS)
    info = {"phase": "sharded", "mesh": f"{SHARDS} shards on one card",
            "rows": search["rows"].shape[0], "dim": DIM, "k": K,
            "queries": NQ}
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    with _no_plain_pq_scan():
        flat = timed("flat", _flat_legs, mesh, search,
                     ("f32", "bf16", "quant", "int8", "int4", "pq"))
        fresh = flat.pop("_f32")
        info["flat"] = flat
        info["grow"] = timed("grow", _grow_leg, mesh, search, fresh)
        del fresh
        torch.cuda.empty_cache()
        info["ivf"] = timed("ivf", _ivf_legs, mesh, search, device)
        if torch.cuda.device_count() > 1:
            gpus = visible_devices("cuda")
            every = timed("every_gpu", _flat_legs, shard_mesh(gpus), search,
                          ("f32", "pq"))
            every.pop("_f32")
            info["every_gpu"] = {"gpus": len(gpus), **every}
        info["dp_encode"] = timed("dp_encode", _dp_encode_leg, device,
                                  images, embs)
        info["process"] = timed("process", _process_leg, device, search)
    launches = kernel_counts()
    # B11 at a shard's shape against its plain version (not counted)
    idx = ShardedVectorIndex.from_codes(search["payloads"]["pq"], mesh)
    with torch.inference_mode():
        q = torch.from_numpy(rotate_rows(search["queries"], idx._rot)).to(
            device)
        _, luti, _ = pq_lib.quantized_luts(q, idx._pq.device(device))
        shard = idx._codes[0]
        out = pqs.pq_scan_scores(shard, luti.T.contiguous())
        ref = pqs.pq_scan_scores_plain(shard, luti.T.contiguous())
        torch.cuda.synchronize()
        check(torch.equal(out, ref), "B11 differs from plain on a shard")
    info["b11_shard_check"] = {"rows": shard.shape[0], "queries": NQ,
                               "bitwise": True}
    del idx
    torch.cuda.empty_cache()
    info["seconds"] = seconds
    emit(info)
    return {"info": info, "launches": launches}


def _kernel_class(name: str) -> str:
    """A coarse class of a CUDA kernel name, for the time by class."""
    low = name.lower()
    if any(t in low for t in ("fprop", "conv", "implicit_gemm", "cudnn",
                              "nhwc", "nchw")):
        return "cuDNN convolution"
    if "sdpa_sm90" in low:
        return "sdpa_sm90 (B2-B4, B8, B10, B9's attention)"
    if "gemm_s8" in low or "quant_rows" in low:
        return "int8 GEMM / row quantizer (B6)"
    if "sm90" in low or "layernorm_rows" in low:
        return "sm90 attention core / GEMM, LayerNorm (B1, B5, B7, B9's GEMM)"
    if "pq_scan" in low:
        return "pq_scan (B11)"
    if "multi_tensor_apply" in low:
        return "optimizer (foreach)"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "cuBLAS GEMM"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def encode_profile(enc, batch: np.ndarray, reps: int, plain_reps: int) -> dict:
    """Where one encode_images(batch) spends device time: torch.profiler's
    CUDA kernel totals over reps calls, by kernel name and by class. The
    card's busy share is that device time over the host's wall per call
    without the profiler (timed here over plain_reps calls), since the
    profiler slows the host; the share under the profiler is beside it."""
    enc.encode_images(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(plain_reps):
        enc.encode_images(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / plain_reps
    kernels, wall_prof = _profiled(lambda: enc.encode_images(batch), reps)
    busy = sum(ms for _, ms, _ in kernels)
    classes: dict = {}
    for name, ms, _ in kernels:
        cls = _kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + ms
    return {"batch": len(batch), "wall_ms_per_batch": wall,
            "wall_ms_per_batch_profiled": wall_prof,
            "profiler_host_overhead_ms": wall_prof - wall,
            "device_ms_per_batch": busy,
            "device_busy_share": busy / wall,
            "device_busy_share_profiled": busy / wall_prof,
            "device_ms_by_class": dict(sorted(classes.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels": [{"name": name[:90], "ms": ms, "calls": n,
                             "share": ms / busy}
                            for name, ms, n in kernels[:12]]}


def phase_profile(enc, images: np.ndarray, encode_info: dict) -> dict:
    """encode_profile of two 128-image ViT-B/32 encodes, with the busy
    share against phase encode's wall per batch too."""
    prof = encode_profile(enc, images[:BATCH], reps=2, plain_reps=8)
    wall_encode = encode_info["seconds"] * 1e3 / (N_IMAGES // BATCH)
    info = {"phase": "profile", **prof,
            "wall_ms_per_batch_encode_phase": wall_encode,
            "device_busy_share_encode_phase":
                prof["device_ms_per_batch"] / wall_encode}
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phases int8 and fused: the opt-in routes of ViT-B/32
# ---------------------------------------------------------------------------

INT8_ATTN_GATE = 0.98  # clipx's drift gate with INT8_ATTN/PATCH (test_quant)


def _encode_all(enc, images: np.ndarray, expect: dict, what: str):
    """encode_images of every BATCH-image batch, timed, each batch's
    launches checked against ``expect``; (embeddings, img/s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runs = [_launched(lambda i=i: enc.encode_images(images[i: i + BATCH]))
            for i in range(0, len(images), BATCH)]
    secs = time.perf_counter() - t0
    for _, n in runs:
        check(n == expect, f"{what}: a batch launched {n}, expected {expect}")
    embs = np.concatenate([e for e, _ in runs])
    _unit_rows(embs, enc.embed_dim, what)
    return embs, len(images) / secs


def phase_int8(device, images: np.ndarray, base: np.ndarray) -> dict:
    """--compute int8 at ViT-B/32 (seeded random weights): 1,024 images in
    batches of 128 and one batch of 1 with CLIPX_FUSED_MLP_INT8=on (B6 12
    times a batch), against the port's CPU f32 int8 encode of the same
    weights (cosine >= COS_MIN) and beside the card's bf16 encode
    (``base``); the same unfused; CLIPX_INT8_ATTN/PATCH on 8 images and 1
    (packed_sdpa_rows, packed_sdpa); ViT-L/14@336px int8, one batch of 128
    (not fusible: no B6); a profile of one 128-image encode."""
    from clipx_torch import config as config_lib
    from clipx_torch.models import convert
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.runtime.encoder import Encoder
    from clipx_torch.utils.env import restoring

    layers = 12
    enc = Encoder.create("ViT-B/32", seed=SEED, device=device,
                         compute_quant="int8")
    # B6 reads the K-major weight copies that quantize_mlp_stack made once:
    # no call of the encode may transpose the weights itself
    mlp = enc.params["visual"]["blocks"]["mlp"]
    check(all(torch.equal(mlp[f"w{i}_qt"], mlp[f"w{i}_q"].transpose(-1, -2))
              and mlp[f"w{i}_qt"].is_contiguous() for i in (1, 2)),
          "the int8 Encoder has no K-major copies of its MLP weights")
    ps.W8A8_WEIGHT_COPIES["calls"] = 0
    cpu = Encoder.create("ViT-B/32", seed=SEED, device="cpu",
                         compute_quant="int8", batch_buckets=(CPU_CHECK,))
    ref = cpu.encode_images(images[:CPU_CHECK])
    del cpu
    info = {"phase": "int8", "model": "ViT-B/32", "images": len(images),
            "batch": BATCH}
    with restoring(CLIPX_FUSED_MLP_INT8="on"):
        enc.warmup(buckets=(1, BATCH))
        embs, info["img_per_s_fused"] = _encode_all(
            enc, images, {"fused_attn_block": layers,
                          "fused_mlp_w8a8": layers}, "int8 fused")
        t0 = time.perf_counter()
        one, n = _launched(lambda: enc.encode_images(images[:1]))
        info["batch1_ms_fused"] = (time.perf_counter() - t0) * 1e3
        check(n == {"packed_sdpa": layers, "fused_mlp_w8a8": layers},
              f"int8 fused batch of 1 launched {n}")
        info["profile_fused"] = encode_profile(enc, images[:BATCH], reps=1,
                                               plain_reps=4)
    info["w8a8_weight_transposes"] = ps.W8A8_WEIGHT_COPIES["calls"]
    check(info["w8a8_weight_transposes"] == 0,
          "the Encoder's fused W8A8 route transposed its weights per call")
    info["cos_vs_cpu_f32_int8_min"] = _cos_min(ref, embs[:CPU_CHECK])
    info["cos_vs_card_bf16_min"] = _cos_min(embs, base)
    info["cos_batch1_vs_batch128"] = float(one[0] @ embs[0])
    check(info["cos_vs_cpu_f32_int8_min"] >= COS_MIN,
          f"int8 card vs CPU f32 int8 cosine {info['cos_vs_cpu_f32_int8_min']}")
    with restoring(CLIPX_FUSED_MLP_INT8="off"):
        enc.warmup(buckets=(BATCH,))
        unfused, info["img_per_s_unfused"] = _encode_all(
            enc, images, {"fused_attn_block": layers}, "int8 unfused")
    info["cos_unfused_vs_fused_min"] = _cos_min(unfused, embs)
    check(info["cos_unfused_vs_fused_min"] >= COS_MIN,
          f"int8 unfused vs fused cosine {info['cos_unfused_vs_fused_min']}")
    del enc

    # W8A8 attention projections and patch embedding
    with restoring(CLIPX_INT8_ATTN="on"), restoring(CLIPX_INT8_PATCH="on"):
        enc = Encoder.create("ViT-B/32", seed=SEED, device=device,
                             compute_quant="int8")
    few = images[:ROUTE_IMAGES]
    out, n8 = _launched(lambda: enc.encode_images(few))
    one, n1 = _launched(lambda: enc.encode_images(few[:1]))
    check(n8 == {"packed_sdpa_rows": layers} and n1 == {"packed_sdpa": layers},
          f"INT8_ATTN launched {n8} for {ROUTE_IMAGES} images and {n1} for 1")
    _unit_rows(out, enc.embed_dim, "int8 attn/patch")
    info["int8_attn_patch"] = {
        "launches_batch8": n8, "launches_batch1": n1,
        "cos_vs_card_bf16_min": _cos_min(out, base[:ROUTE_IMAGES]),
        "cos_batch1_vs_batch8": float(one[0] @ out[0])}
    check(info["int8_attn_patch"]["cos_vs_card_bf16_min"] > INT8_ATTN_GATE,
          f"int8 attn/patch drift {info['int8_attn_patch']}")
    del enc
    torch.cuda.empty_cache()

    # ViT-L/14@336px: the MLP is not fusible there, so no B6
    cfg = config_lib.get_config(LONG_MODEL)
    size = cfg.vision.image_size
    with restoring(CLIPX_FUSED_MLP_INT8="on"):
        enc = Encoder(cfg, convert.init_params(cfg, SEED), device=device,
                      compute_quant="int8", batch_buckets=(BATCH,))
        enc.warmup()
        long_images = np.random.default_rng(SEED + 1).integers(
            0, 256, (BATCH, size, size, 3), dtype=np.uint8)
        _, info["long_img_per_s"] = _encode_all(
            enc, long_images, {"fused_sdpa_long": cfg.vision.layers},
            f"{LONG_MODEL} int8")
    info["long_model"] = LONG_MODEL
    del enc
    torch.cuda.empty_cache()
    emit(info)
    return info


def phase_fused(enc, images: np.ndarray, cpu_ref: np.ndarray) -> dict:
    """ViT-B/32 bf16 under CLIPX_FUSED_MLP=on (B7 in both towers: 1,024
    images, the text p50, then torch.profiler over one 128-image batch)
    and under CLIPX_PACKED_SDPA=sublayer (B5 on
    every even batch: 1,024 images, then a batch of 1 on packed_sdpa), each
    against the CPU f32 encode of phase encode (cosine >= COS_MIN)."""
    from clipx_torch.utils.env import restoring

    layers = enc.cfg.vision.layers
    text_layers = enc.cfg.text.layers
    info = {"phase": "fused", "model": "ViT-B/32", "images": len(images),
            "batch": BATCH}
    with restoring(CLIPX_FUSED_MLP="on"):
        enc.warmup(buckets=(BATCH,))
        embs, info["img_per_s_fused_mlp"] = _encode_all(
            enc, images, {"fused_attn_block": layers, "fused_mlp": layers},
            "CLIPX_FUSED_MLP")
        _, n = _launched(lambda: enc.encode_texts(["a photo of a cat"]))
        check(n == {"fused_mlp": text_layers},
              f"CLIPX_FUSED_MLP text launched {n}")
        info["text_fused_mlp"] = text_latency(enc)
        info["profile_fused_mlp"] = encode_profile(enc, images[:BATCH],
                                                   reps=1, plain_reps=4)
    info["cos_fused_mlp_vs_cpu_f32_min"] = _cos_min(cpu_ref,
                                                    embs[:CPU_CHECK])
    with restoring(CLIPX_PACKED_SDPA="sublayer"):
        enc.warmup(buckets=(BATCH,))
        embs, info["img_per_s_sublayer"] = _encode_all(
            enc, images, {"fused_attn_sublayer": layers}, "sublayer")
        _, n = _launched(lambda: enc.encode_images(images[:1]))
        check(n == {"packed_sdpa": layers},
              f"sublayer batch of 1 launched {n}")
    info["cos_sublayer_vs_cpu_f32_min"] = _cos_min(cpu_ref, embs[:CPU_CHECK])
    for key in ("cos_fused_mlp_vs_cpu_f32_min", "cos_sublayer_vs_cpu_f32_min"):
        check(info[key] >= COS_MIN, f"{key} {info[key]}")
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase 8: the long-sequence towers
# ---------------------------------------------------------------------------

LONG_MODEL, LONG_IMAGES, LONG_CPU_CHECK, ROUTE_IMAGES = (
    "ViT-L/14@336px", 256, 2, 8)
LOGIT_ATOL = 0.05  # clip_forward logits vs the default route, x logit scale


def kernel_counts() -> dict:
    """The kernels' launch counts (``ops/_launch.py``) without its
    ``FORWARD_COUNTS``, which count forwards, not kernels."""
    from clipx_torch.ops import _launch

    return {k: n for k, n in _launch.launch_counts().items()
            if k not in _launch.FORWARD_COUNTS}


def _launched(fn):
    """(fn(), {kernel: launches} of the kernels fn launched)."""
    before = kernel_counts()
    out = fn()
    return out, {k: n - before[k] for k, n in kernel_counts().items()
                 if n != before[k]}


def _unit_rows(embs: np.ndarray, dim: int, what: str) -> None:
    check(embs.shape[1] == dim and bool(np.isfinite(embs).all())
          and bool(np.allclose(np.linalg.norm(embs, axis=1), 1.0,
                               atol=1e-3)),
          f"{what}: embeddings not finite unit rows of width {dim}")


def _cos_min(a: np.ndarray, b: np.ndarray) -> float:
    return float((a * b).sum(axis=1).min())


def _other_towers(device) -> dict:
    """ViT-B/16 (S = 197: fused_sdpa_long) and ViT-B/32 under
    CLIPX_PACKED_SDPA=qkv (packed_sdpa_qkv) and =rows (packed_sdpa_rows),
    ROUTE_IMAGES images each; the variants against ViT-B/32's default
    route on the same images."""
    from clipx_torch.runtime.encoder import Encoder
    from clipx_torch.utils.env import restoring

    out = {}
    for model, runs in (("ViT-B/16", (("auto", "fused_sdpa_long"),)),
                        ("ViT-B/32", (("auto", "fused_attn_block"),
                                      ("qkv", "packed_sdpa_qkv"),
                                      ("rows", "packed_sdpa_rows")))):
        enc = Encoder.create(model, seed=SEED, device=device)
        size, layers = enc.image_size, enc.cfg.vision.layers
        images = np.random.default_rng(SEED + 2).integers(
            0, 256, (ROUTE_IMAGES, size, size, 3), dtype=np.uint8)
        base = None
        for variant, kernel in runs:
            with restoring(CLIPX_PACKED_SDPA=variant):
                embs, n = _launched(lambda: enc.encode_images(images))
            check(n == {kernel: layers},
                  f"{model} CLIPX_PACKED_SDPA={variant}: launches {n}, "
                  f"expected {layers} of {kernel}")
            _unit_rows(embs, enc.embed_dim, f"{model} {variant}")
            row = {"launches": n}
            if base is None:
                base = embs
            else:
                row["cos_vs_default_min"] = _cos_min(embs, base)
                check(row["cos_vs_default_min"] >= COS_MIN,
                      f"{model} {variant} vs default: cosine "
                      f"{row['cos_vs_default_min']}")
            out[f"{model} {variant}"] = row
        del enc
        torch.cuda.empty_cache()
    return out


def phase_long(device) -> dict:
    """The long-sequence towers' path: ViT-L/14@336px at full width with
    seeded random weights through the Encoder, its text tower and search,
    every attention route of clipx (default, CLIPX_PACKED_SDPA=qkv,
    attn_impl="pallas" and clip_forward), then ViT-B/16 and ViT-B/32's
    variants. Launch counts are checked per call."""
    from clipx_torch import config as config_lib
    from clipx_torch.models import clip as model_lib
    from clipx_torch.models import convert
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.ops.preprocess import normalize_batch
    from clipx_torch.runtime.encoder import Encoder
    from clipx_torch.utils.env import restoring

    cfg = config_lib.get_config(LONG_MODEL)
    layers, text_layers = cfg.vision.layers, cfg.text.layers
    t0 = time.perf_counter()
    params = convert.init_params(cfg, SEED)
    enc = Encoder(cfg, params, device=device)
    enc.warmup(buckets=(1, BATCH))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    size = cfg.vision.image_size
    images = np.random.default_rng(SEED + 1).integers(
        0, 256, (LONG_IMAGES, size, size, 3), dtype=np.uint8)

    # every bucket: layers launches of fused_sdpa_long and nothing else
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [_launched(lambda i=i: enc.encode_images(images[i: i + BATCH]))
               for i in range(0, LONG_IMAGES, BATCH)]
    secs = time.perf_counter() - t0
    t1 = time.perf_counter()
    one, n_one = _launched(lambda: enc.encode_images(images[:1]))
    one_s = time.perf_counter() - t1
    for n in [n for _, n in batches] + [n_one]:
        check(n == {"fused_sdpa_long": layers},
              f"{LONG_MODEL} batch launched {n}, expected {layers} of "
              f"fused_sdpa_long")
    embs = np.concatenate([e for e, _ in batches])
    _unit_rows(embs, cfg.embed_dim, LONG_MODEL)
    cos_one = float(one[0] @ embs[0])
    check(cos_one >= COS_MIN, f"batch-1 vs batch-128 cosine {cos_one}")

    # the same weights in f32 on the CPU
    cpu = Encoder(cfg, params, device="cpu", batch_buckets=(LONG_CPU_CHECK,))
    ref = cpu.encode_images(images[:LONG_CPU_CHECK])
    del cpu
    cos_cpu = _cos_min(ref, embs[:LONG_CPU_CHECK])
    check(cos_cpu >= COS_MIN, f"{LONG_MODEL} card vs CPU f32 cosine {cos_cpu}")

    text = text_latency(enc)
    found = corpus_search(embs, device, cfg.embed_dim)
    search = found["info"]
    del found
    torch.cuda.empty_cache()

    # the attention routes on ROUTE_IMAGES images (bucket 8)
    few = images[:ROUTE_IMAGES]
    base = enc.encode_images(few)
    routes = {}
    with restoring(CLIPX_PACKED_SDPA="qkv"):
        out, n = _launched(lambda: enc.encode_images(few))
    check(n == {"fused_sdpa_long_qkv": layers},
          f"CLIPX_PACKED_SDPA=qkv launched {n}, expected {layers} of "
          f"fused_sdpa_long_qkv")
    routes["qkv"] = {"launches": n, "cos_vs_default_min": _cos_min(out, base)}
    pallas = Encoder(cfg, params, device=device, attn_impl="pallas")
    out, n = _launched(lambda: pallas.encode_images(few))
    check(n == {"flash_attention": layers},
          f'attn_impl="pallas" launched {n}, expected {layers} of '
          f"flash_attention")
    routes["pallas"] = {"launches": n,
                        "cos_vs_default_min": _cos_min(out, base)}
    for name, r in routes.items():
        check(r["cos_vs_default_min"] >= COS_MIN,
              f"route {name} vs default: cosine {r['cos_vs_default_min']}")
    # clip_forward with "pallas": the causal text tower takes the kernel too
    texts = ["a photo of a cat", "two dogs on a beach"]
    ids = torch.from_numpy(enc.tokenizer(
        texts, context_length=cfg.text.context_length)).to(device)
    pixels = normalize_batch(torch.from_numpy(few[:2]).to(device),
                             dtype=enc.dtype)
    with torch.inference_mode():
        (logits, _), n = _launched(lambda: model_lib.clip_forward(
            pallas.params, cfg, pixels, ids, dtype=enc.dtype,
            attn_impl="pallas"))
    del pallas
    check(n == {"flash_attention": layers + text_layers},
          f'clip_forward(attn_impl="pallas") launched {n}, expected '
          f"{layers + text_layers} of flash_attention")
    scale = float(np.exp(params["logit_scale"]))
    want = scale * base[:2] @ enc.encode_texts(texts).T
    logit_err = float(np.abs(logits.float().cpu().numpy() - want).max())
    check(logit_err <= LOGIT_ATOL * scale,
          f"clip_forward pallas logits differ from the default route by "
          f"{logit_err}")
    routes["clip_forward_pallas"] = {"launches": n,
                                     "logits_max_abs_diff": logit_err,
                                     "logit_scale": scale}
    del params

    profile = encode_profile(enc, images[:BATCH], reps=1, plain_reps=4)
    del enc
    torch.cuda.empty_cache()
    routes.update(_other_towers(device))
    info = {"phase": "long", "model": LONG_MODEL, "images": LONG_IMAGES,
            "batch": BATCH, "setup_s": setup_s, "seconds": secs,
            "img_per_s": LONG_IMAGES / secs, "batch1_ms": one_s * 1e3,
            "attn_launches_per_batch": layers,
            "cos_vs_cpu_f32_min": cos_cpu, "cos_tolerance": COS_MIN,
            "cos_batch1_vs_batch128": cos_one,
            "text": text, "search": search, "routes": routes,
            "profile": profile}
    emit(info)
    return info


SIGLIP_MODEL, SIGLIP_IMAGES, SIGLIP_CPU_CHECK = (
    "SigLIP-so400m/14@384", 256, 2)


def phase_siglip(device) -> dict:
    """SigLIP so400m/14@384's indexing path at published widths and whole
    depth with seeded random weights: SIGLIP_IMAGES frames at 384 px
    through encode_images_async / finalize, two batches of BATCH in
    flight (the indexer's and the index-so400m cell's path), then one
    batch of 1. Each batch launches B8 (fused_sdpa_long, D = 72, S = 729)
    once a layer and no other kernel of the port; a few embeddings against
    the port's CPU f32 encode of the same weights."""
    from clipx_torch import config as config_lib
    from clipx_torch.models import convert
    from clipx_torch.runtime.encoder import Encoder

    cfg = config_lib.get_config(SIGLIP_MODEL)
    v = cfg.vision
    layers = v.layers
    check(v.width // v.heads == 72 and v.seq_len == 729,
          f"{SIGLIP_MODEL}: head dim {v.width // v.heads}, S {v.seq_len}")
    t0 = time.perf_counter()
    params = convert.init_params(cfg, SEED)
    enc = Encoder(cfg, params, device=device)
    enc.warmup(buckets=(1, BATCH))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    size = v.image_size
    images = np.random.default_rng(SEED + 3).integers(
        0, 256, (SIGLIP_IMAGES, size, size, 3), dtype=np.uint8)

    # two in flight, as the indexer holds them: one batch's launches a
    # finalize, each read while the next batch is already enqueued
    before = kernel_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending, embs = [], []
    for i in range(0, SIGLIP_IMAGES, BATCH):
        pending.append(enc.encode_images_async(images[i: i + BATCH]))
        if len(pending) == 2:
            embs.append(enc.finalize(pending.pop(0)))
    embs += [enc.finalize(h) for h in pending]
    secs = time.perf_counter() - t0
    n = {k: c - before[k] for k, c in kernel_counts().items()
         if c != before[k]}
    batches = SIGLIP_IMAGES // BATCH
    check(n == {"fused_sdpa_long": layers * batches},
          f"{SIGLIP_MODEL}: {batches} batches launched {n}, expected "
          f"{layers} of fused_sdpa_long a batch")
    t1 = time.perf_counter()
    one, n_one = _launched(lambda: enc.encode_images(images[:1]))
    one_s = time.perf_counter() - t1
    check(n_one == {"fused_sdpa_long": layers},
          f"{SIGLIP_MODEL} batch of 1 launched {n_one}, expected {layers} "
          f"of fused_sdpa_long")
    embs = np.concatenate(embs)
    _unit_rows(embs, cfg.embed_dim, SIGLIP_MODEL)
    cos_one = float(one[0] @ embs[0])
    check(cos_one >= COS_MIN, f"{SIGLIP_MODEL} batch-1 vs batch-128 cosine "
          f"{cos_one}")
    try:
        enc.encode_texts(["a photo of a cat"])
        refused = False
    except ValueError:
        refused = True
    check(refused, f"{SIGLIP_MODEL}: encode_texts ran without its "
          "SentencePiece model")
    del enc
    torch.cuda.empty_cache()

    cpu = Encoder(cfg, params, device="cpu",
                  batch_buckets=(SIGLIP_CPU_CHECK,))
    ref = cpu.encode_images(images[:SIGLIP_CPU_CHECK])
    del cpu, params
    cos_cpu = _cos_min(ref, embs[:SIGLIP_CPU_CHECK])
    check(cos_cpu >= COS_MIN,
          f"{SIGLIP_MODEL} card vs CPU f32 cosine {cos_cpu}")
    info = {"phase": "siglip", "model": SIGLIP_MODEL,
            "images": SIGLIP_IMAGES, "batch": BATCH, "in_flight": 2,
            "setup_s": setup_s, "seconds": secs,
            "img_per_s": SIGLIP_IMAGES / secs, "batch1_ms": one_s * 1e3,
            "attn_launches_per_batch": layers, "launches": n,
            "cos_vs_cpu_f32_min": cos_cpu, "cos_tolerance": COS_MIN,
            "cos_batch1_vs_batch128": cos_one}
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phases preprocess, resnet and quality
# ---------------------------------------------------------------------------

CANVAS = 256           # ViT-B/32's --preprocess device canvas, (224*8+6)//7
RESIZE_ATOL = 1e-4     # card f32 resize vs CPU f32 (summation order only)


def phase_preprocess(enc, encoded: dict) -> dict:
    """--preprocess device at ViT-B/32 with phase encode's weights: 1,024
    seeded 256 x 256 canvases in batches of 128 (B1 once a layer), then one
    batch of 1 (B2 once a layer), img/s beside phase encode's 224 px
    img/s; a few canvases against the port's CPU f32 canvas path (cosine
    >= COS_MIN); the resize alone, card f32 against CPU f32 within
    RESIZE_ATOL, and its CUDA-event time; a non-square batch raises."""
    from clipx_torch.ops.preprocess import (device_resize_normalize,
                                            resize_weights)

    layers, size = enc.cfg.vision.layers, enc.image_size
    canvases = np.random.default_rng(SEED + 5).integers(
        0, 256, (N_IMAGES, CANVAS, CANVAS, 3), dtype=np.uint8)
    enc.encode_images(canvases[:BATCH])            # first use of the shape
    embs, img_per_s = _encode_all(enc, canvases,
                                  {"fused_attn_block": layers}, "canvases")
    t0 = time.perf_counter()
    one, n_one = _launched(lambda: enc.encode_images(canvases[:1]))
    one_ms = (time.perf_counter() - t0) * 1e3
    check(n_one == {"packed_sdpa": layers},
          f"a canvas batch of 1 launched {n_one}, expected {layers} of "
          "packed_sdpa")
    cos_one = float(one[0] @ embs[0])
    check(cos_one >= COS_MIN, f"canvas batch-1 vs batch-128 cosine {cos_one}")
    ref = encoded["cpu"].encode_images(canvases[:CPU_CHECK])
    cos_cpu = _cos_min(ref, embs[:CPU_CHECK])
    check(cos_cpu >= COS_MIN, f"canvas path card vs CPU f32 cosine {cos_cpu}")

    # the resize alone at the indexing batch, f32 on both devices
    host = torch.from_numpy(canvases[:BATCH])
    dev = host.to(enc.device)
    with torch.inference_mode():
        card = device_resize_normalize(dev, size)
        cpu = device_resize_normalize(host[:8], size)
        err = float((card[:8].cpu() - cpu).abs().max())
        check(err <= RESIZE_ATOL,
              f"resize card vs CPU f32 max abs error {err} > {RESIZE_ATOL}")
        resize_ms = cuda_ms(lambda: device_resize_normalize(
            dev, size, dtype=torch.bfloat16), iters=20)
        resize_device_ms = device_ms(lambda: device_resize_normalize(
            dev, size, dtype=torch.bfloat16), iters=10)
    try:
        enc.encode_images(np.zeros((2, CANVAS, CANVAS + 64, 3), np.uint8))
        raised = False
    except ValueError as exc:
        raised = "square canvas" in str(exc)
    check(raised, "a non-square batch did not raise the square-canvas error")
    base = encoded["info"]["img_per_s"]
    # bytes and operations of the resize of one 128-canvas batch: uint8 in,
    # bf16 out. The function needs only the weight matrix's nonzero taps
    # (about 5 an output sample); the dense contractions that run multiply
    # every input row and column, so their bound is reported beside it.
    nbytes = BATCH * 3 * (CANVAS * CANVAS + 2 * size * size)
    taps = int(np.count_nonzero(resize_weights(CANVAS, size)))
    flops = 2 * BATCH * 3 * taps * (CANVAS + size)
    dense_flops = 2 * BATCH * 3 * size * CANVAS * (CANVAS + size)
    bms, by = bound(flops, nbytes, PEAK_F32_FLOPS)
    dense_bms, dense_by = bound(dense_flops, nbytes, PEAK_F32_FLOPS)
    info = {"phase": "preprocess", "model": "ViT-B/32", "canvas": CANVAS,
            "images": N_IMAGES, "batch": BATCH, "img_per_s": img_per_s,
            "img_per_s_224_encode_phase": base,
            "canvas_vs_224_ratio": img_per_s / base, "batch1_ms": one_ms,
            "launches_batch1": n_one, "cos_vs_cpu_f32_min": cos_cpu,
            "cos_batch1_vs_batch128": cos_one,
            "resize_max_abs_err_vs_cpu": err, "resize_atol": RESIZE_ATOL,
            "resize_ms_batch128": resize_ms,
            "resize_device_ms_batch128": resize_device_ms,
            "resize_taps_per_sample": taps / size,
            "resize_bound_ms": bms, "resize_bound_by": by,
            "resize_dense_bound_ms": dense_bms,
            "resize_dense_bound_by": dense_by,
            "non_square_raises": raised}
    emit(info)
    return info


RN_MODEL, RN_OTHERS, RN_FEW, RN_CPU_FEW = (
    "RN50", ("RN101", "RN50x4", "RN50x16", "RN50x64"), 8, 2)


def _rn_encoders(name: str, device, buckets):
    """(card Encoder, CPU f32 Encoder, setup seconds) of one RN preset,
    both from one seeded numpy init."""
    from clipx_torch import config as config_lib
    from clipx_torch.models import convert
    from clipx_torch.runtime.encoder import Encoder

    cfg = config_lib.get_config(name)
    t0 = time.perf_counter()
    params = convert.init_params(cfg, SEED)
    enc = Encoder(cfg, params, device=device, batch_buckets=buckets)
    enc.warmup(buckets=buckets)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cpu = Encoder(cfg, params, device="cpu", batch_buckets=(RN_CPU_FEW,))
    return enc, cpu, setup_s


def phase_resnet(device) -> dict:
    """The ResNet towers at full width with seeded random weights: RN50 on
    1,024 seeded 224 x 224 images in batches of 128 and one of 1 (img/s,
    unit rows, no kernel of the port launched), against the CPU's f32
    encode on CPU_CHECK images; a torch.profiler breakdown of one batch;
    RN50's text p50; then RN101, RN50x4, RN50x16 and RN50x64 on RN_FEW
    images each (batch ms), against the CPU on RN_CPU_FEW."""
    enc, cpu, setup_s = _rn_encoders(RN_MODEL, device, (1, 8, BATCH))
    images = np.random.default_rng(SEED + 6).integers(
        0, 256, (N_IMAGES, 224, 224, 3), dtype=np.uint8)
    embs, img_per_s = _encode_all(enc, images, {}, RN_MODEL)
    t0 = time.perf_counter()
    one, n_one = _launched(lambda: enc.encode_images(images[:1]))
    one_ms = (time.perf_counter() - t0) * 1e3
    check(n_one == {}, f"{RN_MODEL} batch of 1 launched {n_one}")
    cos_one = float(one[0] @ embs[0])
    check(cos_one >= COS_MIN, f"{RN_MODEL} batch-1 vs 128 cosine {cos_one}")
    ref = cpu.encode_images(images[:CPU_CHECK])
    del cpu
    cos_cpu = _cos_min(ref, embs[:CPU_CHECK])
    check(cos_cpu >= COS_MIN, f"{RN_MODEL} card vs CPU f32 cosine {cos_cpu}")
    profile = encode_profile(enc, images[:BATCH], reps=2, plain_reps=8)
    text = text_latency(enc)
    del enc
    torch.cuda.empty_cache()

    others = {}
    for name in RN_OTHERS:
        enc, cpu, setup = _rn_encoders(name, device, (RN_FEW,))
        size = enc.image_size
        few = np.random.default_rng(SEED + 7).integers(
            0, 256, (RN_FEW, size, size, 3), dtype=np.uint8)
        times, launched = [], {}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, n = _launched(lambda: enc.encode_images(few))
            times.append((time.perf_counter() - t0) * 1e3)
            launched.update(n)
        check(launched == {}, f"{name} launched {launched}")
        _unit_rows(out, enc.embed_dim, name)
        cos = _cos_min(cpu.encode_images(few[:RN_CPU_FEW]),
                       out[:RN_CPU_FEW])
        check(cos >= COS_MIN, f"{name} card vs CPU f32 cosine {cos}")
        others[name] = {"image_size": size, "setup_s": setup,
                        "batch": RN_FEW,
                        "batch_ms_median": statistics.median(times),
                        "batch_ms": times, "cos_vs_cpu_f32_min": cos}
        del enc, cpu
        torch.cuda.empty_cache()
    info = {"phase": "resnet", "model": RN_MODEL, "setup_s": setup_s,
            "images": N_IMAGES, "batch": BATCH, "img_per_s": img_per_s,
            "batch1_ms": one_ms, "launches_per_batch": {},
            "cos_vs_cpu_f32_min": cos_cpu, "cos_batch1_vs_batch128": cos_one,
            "cos_tolerance": COS_MIN, "profile": profile, "text": text,
            "others": others}
    emit(info)
    return info


# tests/test_quality_gate.py's floors: (stdout pattern, floor per group)
QUALITY_FLOORS = (
    (r"self-retrieval: (\d+)/(\d+) rank-0 hits", None),
    (r"int8\+rescore vs exact: recall@50 ([0-9.]+), top-1 agreement "
     r"([0-9.]+)", (1.0, 1.0)),
    (r"bf16-corpus int8\+rescore vs exact f32: recall@50 ([0-9.]+), "
     r"top-1 agreement ([0-9.]+)", (0.99, 1.0)),
    (r"int8-storage vs exact f32: recall@50 ([0-9.]+), top-1 agreement "
     r"([0-9.]+)", (0.97, 1.0)),
    (r"int4-storage vs exact f32: recall@50 ([0-9.]+), top-1 agreement "
     r"([0-9.]+)", (0.85, 1.0)),
    (r"pq-storage \(dsub=2, opq=trained\) vs exact f32: recall@50 "
     r"([0-9.]+), top-1 agreement ([0-9.]+)", (0.45, 1.0)),
    (r"ivf vs exact \(IVFIndex\): recall@50 ([0-9.]+) at nprobe=100, "
     r"([0-9.]+) at nprobe=32", (1.0, 0.0)),
    (r"ivf-int8 vs exact: recall@50 ([0-9.]+) at nprobe=100", (0.95,)),
    (r"ivf-int8-storage vs exact f32: recall@50 ([0-9.]+) at nprobe=100",
     (0.95,)),
    (r"ivf-int4-storage vs exact f32: recall@50 ([0-9.]+) at nprobe=100",
     (0.80,)),
    (r"ivf-pq-storage \(residual=on\) vs exact f32: recall@50 ([0-9.]+) "
     r"at nprobe=100, ([0-9.]+) at nprobe=32", (0.45, 0.0)))
DRIFT_CV2_MIN, DRIFT_INT8_MIN = 0.9999, 0.99


def _quiet(fn, *args):
    """(fn(*args), its stdout)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def phase_quality() -> dict:
    """The port's quality tool on the card: tests/test_quality_gate.py's
    corpus (10,000 x 512 from RandomState(0), k = 50), every line held to
    that test's floors; then the drift leg over 12 PNGs that the port's
    build_index indexed at ViT-B/32 on the card (cv2 >= 0.9999, int8
    compute >= 0.99; PIL reported: its 0.90 floor is tiny-test's)."""
    from PIL import Image

    from clipx_torch.cli import build_index
    from clipx_torch.search.engine import IndexWriter
    from clipx_torch.tools import eval_quality

    rng = np.random.RandomState(0)
    corpus = rng.randn(10_000, 512).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    info = {"phase": "quality", "lines": {}}
    with tempfile.TemporaryDirectory() as tmp:
        index = os.path.join(tmp, "gate.index")
        writer = IndexWriter(index, *corpus.shape)
        writer.write(corpus)
        writer.close()
        t0 = time.perf_counter()
        rc, out = _quiet(eval_quality.main, ["--index", index, "--k", "50"])
        info["gate_seconds"] = time.perf_counter() - t0
        check(rc == 0, f"eval_quality returned {rc}:\n{out}")
        for pattern, floors in QUALITY_FLOORS:
            m = re.search(pattern, out)
            check(m is not None, f"eval_quality printed no {pattern!r}")
            values = [float(v) for v in m.groups()]
            info["lines"][pattern.split(" ")[0].replace("\\", "")] = values
            if floors is None:
                check(values[0] == values[1], f"self-retrieval {values}")
                continue
            check(all(v >= f for v, f in zip(values, floors)),
                  f"{m.group(0)} is below its floors {floors}")

        photos = os.path.join(tmp, "photos") + os.sep
        os.makedirs(photos)
        rng = np.random.RandomState(1)
        for i in range(12):
            base = rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)
            Image.fromarray(base).resize((64, 48), Image.BILINEAR).save(
                f"{photos}p{i:02d}.png")
        db, idx = os.path.join(tmp, "vectors.lmdb"), os.path.join(
            tmp, "images.index")
        t0 = time.perf_counter()
        rc, out = _quiet(build_index.main, ["--db", db, "--index", idx,
                                            photos])
        info["build_seconds"] = time.perf_counter() - t0
        check(rc == 0 and "Done!" in out, f"build_index failed:\n{out}")
        t0 = time.perf_counter()
        rc, out = _quiet(eval_quality.main, [
            "--index", idx, "--db", db, "--photos", photos, "--model",
            "ViT-B/32", "--samples", "12", "--k", "10"])
        info["drift_seconds"] = time.perf_counter() - t0
        check(rc == 0, f"eval_quality --photos returned {rc}:\n{out}")
        m = re.search(r"pil min ([0-9.-]+) mean ([0-9.-]+); cv2 min "
                      r"([0-9.-]+) mean ([0-9.-]+)", out)
        m8 = re.search(r"int8-compute drift vs bf16 \(cosine, n=(\d+)\): "
                       r"min ([0-9.-]+) mean ([0-9.-]+)", out)
        check(m is not None and m8 is not None,
              f"eval_quality printed no drift lines:\n{out}")
        pil_min, pil_mean, cv2_min, cv2_mean = map(float, m.groups())
        info.update({"drift_pil_min": pil_min, "drift_pil_mean": pil_mean,
                     "drift_cv2_min": cv2_min, "drift_cv2_mean": cv2_mean,
                     "drift_int8_n": int(m8.group(1)),
                     "drift_int8_min": float(m8.group(2)),
                     "drift_int8_mean": float(m8.group(3)),
                     "floors": {"cv2": DRIFT_CV2_MIN,
                                "int8": DRIFT_INT8_MIN}})
        check(cv2_min >= DRIFT_CV2_MIN,
              f"cv2 drift {cv2_min} < {DRIFT_CV2_MIN}")
        check(info["drift_int8_n"] == 12
              and info["drift_int8_min"] >= DRIFT_INT8_MIN,
              f"int8 compute drift {m8.group(0)}")
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase train: contrastive training (clipx_torch/train.py, cli/train.py)
# ---------------------------------------------------------------------------

TRAIN_MODEL, TRAIN_RN = "ViT-B/32", "RN50"
TRAIN_PAIRS = 256          # seeded 224 x 224 JPEG + caption pairs
TRAIN_BATCH = 64           # clipx-train's default --batch-size
# steps of the CLI run before its SIGTERM, then of its resume (cut from 40
# and 10 to keep the whole script inside its time limit on a slow host)
TRAIN_CLI_STEPS = 20
TRAIN_RESUME_STEPS = 5
TRAIN_TIMED_STEPS = 10     # in-process steps: CUDA-event median, --remat
TRAIN_CPU_BATCH, TRAIN_CPU_STEPS, TRAIN_RN_CPU_BATCH = 8, 3, 4
TRAIN_LR = 1e-5            # card vs CPU: clipx-train's default --lr
# card vs CPU, both f32 with TF32 off (the same code and params): summation
# order only. Loss per step within 1e-4 relative (12 layers, sums over 768
# and 3072 wide rows); the pre-clip grad norm within 1e-3; accuracy equal.
# Each parameter's update (p - p0): Adam's first steps move an element by
# ~lr * sign(g), so an element whose gradient sits at rounding noise may
# move the other way; the ViT's updates within 5 % of a step of each other
# and their relative L2 error within 1e-3. cuDNN's f32 convolution
# algorithms leave ~4e-3 relative error on RN50's conv gradients against
# the CPU's (measured, TF32 off; TF32 on gives ~1e-1), so more of RN50's
# elements flip: its updates' relative L2 error within 5e-2, their largest
# difference reported
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-4, 1e-3
TRAIN_UPDATE_ATOL, TRAIN_UPDATE_RL2 = 0.05 * TRAIN_LR, 1e-3
TRAIN_RN_UPDATE_RL2 = 5e-2
REMAT_LOSS_RTOL = 1e-6     # --remat recomputes the same ops on the card
TRAIN_CAPTIONS = ("a red square", "a green field", "blue sky over a city",
                  "a dog on the beach", "two cats asleep", "a sunset",
                  "the ocean at night", "a forest path")


def _pair_folder(root: str) -> str:
    """TRAIN_PAIRS seeded 224 x 224 JPEGs, each with a caption sidecar."""
    from PIL import Image

    d = os.path.join(root, "pairs")
    os.makedirs(d)
    rng = np.random.default_rng(SEED + 11)
    for i in range(TRAIN_PAIRS):
        # smooth colour fields (8 x 8 upsampled), JPEG-sized like photos
        base = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        Image.fromarray(base).resize((224, 224), Image.BILINEAR).save(
            os.path.join(d, f"p{i:04d}.jpg"), quality=90)
        with open(os.path.join(d, f"p{i:04d}.txt"), "w") as f:
            f.write(f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]} {i}")
    return d


def _train_setup(name: str, tree, device, lr: float, warmup: int,
                 total: int, remat: bool = False, mesh=None):
    """(state, step) of the single-device step on ``device``, or with
    ``mesh`` of the sharded one, whose step takes the whole batch and
    splits it over the mesh itself."""
    from clipx_torch import config as config_lib
    from clipx_torch import train as ttrain
    from clipx_torch.models import convert

    cfg = config_lib.get_config(name)
    tx = ttrain.make_optimizer(lr, 0.02, warmup, total)
    if mesh is None:
        state, tx = ttrain.create_train_state(cfg, tx=tx, device=device,
                                              params=tree)
        return state, ttrain.make_train_step(cfg, tx, remat=remat)
    # a fresh state straight from the numpy tree (zero moments), as
    # create_train_state would make it, without its host copies
    zeros = {}
    for key, val in convert._flatten(tree).items():
        node = zeros
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.zeros_like(val)
    state = ttrain.TrainState(tree, ttrain.AdamWState(0, zeros, zeros), 0)
    sharded, shard_state, split = ttrain.make_sharded_train_step(
        cfg, tx, mesh, remat=remat)
    return shard_state(state), (
        lambda state, px, ids: sharded(state, *split(px, ids)))


def _flat_params(params) -> dict:
    """A param tree (or a sharded one, gathered whole) as clipx's flat
    numpy layout."""
    from clipx_torch.models import convert
    from clipx_torch.parallel.mesh import Sharded

    if isinstance(params, Sharded):
        params = params.gather()
    return convert._flatten(convert.to_jax_params(params))


def _update_diff(card: dict, cpu: dict, init: dict):
    """(largest |difference|, relative L2 error, largest |update|) of the
    card's parameter updates against the CPU's."""
    max_abs, sq_err, sq_ref, moved = 0.0, 0.0, 0.0, 0.0
    for key, p0 in init.items():
        dc = card[key].astype(np.float64) - p0
        dp = cpu[key].astype(np.float64) - p0
        max_abs = max(max_abs, float(np.abs(dc - dp).max()))
        sq_err += float(((dc - dp) ** 2).sum())
        sq_ref += float((dp ** 2).sum())
        moved = max(moved, float(np.abs(dp).max()))
    return max_abs, (sq_err / sq_ref) ** 0.5, moved


def _replicas_bitwise(sharded) -> int:
    """Checks that the trees of one tp column, and every tree's replicated
    leaves, are equal bit for bit across the mesh's placements; returns
    the number of trees compared."""
    from clipx_torch import train as ttrain

    trees = sharded.placements()
    flags = ttrain._sharded_flags(trees[0][1], sharded.specs, sharded.tp)
    firsts = {}
    for pos, tree in trees:
        leaves = ttrain.tree_leaves(tree)
        ref = ttrain.tree_leaves(firsts.setdefault(sharded.column(pos),
                                                   tree))
        rep = ttrain.tree_leaves(trees[0][1])
        for a, b, c, split in zip(leaves, ref, rep, flags):
            check(torch.equal(a, b.to(a.device))
                  and (split or torch.equal(a, c.to(a.device))),
                  "replicas of a leaf differ after the sharded steps")
    return len(trees)


def _batches(pairs, size: int, batch: int, n: int, device):
    from clipx_torch.cli.train import PairLoader

    loader = PairLoader(pairs, size, 77, batch, SEED)
    out = []
    for _ in range(n):
        px, ids = loader.next_batch()
        out.append((torch.from_numpy(px).to(device),
                    torch.from_numpy(ids).to(device)))
    return out


def _card_vs_cpu(name: str, tree, pairs, batch: int, steps: int,
                 warmup: int, device, atol, rl2: float, mesh=None,
                 cpu_run=None) -> dict:
    """``steps`` steps of one seeded batch on the card (over ``mesh``, when
    given) and on the CPU from one tree: per-step loss, accuracy and grad
    norm, and every parameter's update, against the stated tolerances
    (``atol`` None: the largest update difference is reported, not
    bounded). ``cpu_run`` is an earlier call's CPU run (its "_cpu" entry)
    of the same batch, taken instead of running the CPU again."""
    from clipx_torch.models import convert

    size = 224
    runs = []
    for dev in ((device,) if cpu_run else (device, torch.device("cpu"))):
        px, ids = (cpu_run["batch"] if cpu_run
                   else _batches(pairs, size, batch, 1, dev)[0])
        state, step = _train_setup(name, tree, dev, TRAIN_LR, warmup, steps,
                                   mesh=mesh if dev == device else None)
        metrics = []
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, px, ids)
            metrics.append({k: float(v) for k, v in m.items()})
        secs = time.perf_counter() - t0
        replicas = (_replicas_bitwise(state.params)
                    if mesh is not None and dev == device else None)
        runs.append((_flat_params(state.params), metrics, secs))
        if dev != device:
            cpu_run = {"batch": (px, ids), "params": runs[-1][0],
                       "metrics": metrics, "seconds": secs}
        del state, step
        torch.cuda.empty_cache()
    if len(runs) == 1:
        runs.append((cpu_run["params"], cpu_run["metrics"],
                     cpu_run["seconds"]))
    (card, cm, card_s), (cpu, pm, cpu_s) = runs
    init = convert._flatten(tree)
    max_abs, rel, moved = _update_diff(card, cpu, init)
    for a, b in zip(cm, pm):
        check(abs(a["loss"] - b["loss"]) <= TRAIN_LOSS_RTOL * abs(b["loss"]),
              f"{name}: card loss {a['loss']} vs CPU {b['loss']}")
        check(abs(a["grad_norm"] - b["grad_norm"])
              <= TRAIN_GNORM_RTOL * b["grad_norm"],
              f"{name}: card grad norm {a['grad_norm']} vs CPU "
              f"{b['grad_norm']}")
        check(a["accuracy"] == b["accuracy"],
              f"{name}: card accuracy {a['accuracy']} vs CPU {b['accuracy']}")
    check(moved > 0, f"{name}: no parameter moved in {steps} steps")
    check((atol is None or max_abs <= atol) and rel <= rl2,
          f"{name}: card vs CPU updates differ by {max_abs} (max) and "
          f"{rel} (relative L2)")
    return {"batch": batch, "steps": steps, "lr": TRAIN_LR, "card": cm,
            "cpu": pm, "update_max_abs_diff": max_abs, "update_rel_l2": rel,
            "update_max_abs": moved, "card_s": card_s, "cpu_s": cpu_s,
            "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                          "grad_norm_rtol": TRAIN_GNORM_RTOL,
                          "update_atol": atol, "update_rel_l2": rl2},
            "replica_trees_bitwise": replicas, "_cpu": cpu_run}


def _timed_steps(name: str, tree, batches, device, remat: bool = False,
                 mesh=None):
    """TRAIN_TIMED_STEPS steps (CLI defaults: lr 1e-5, warmup 100) on
    ``batches`` (over ``mesh``, when given): losses, CUDA-event ms of each,
    the allocator's peak."""
    state, step = _train_setup(name, tree, device, 1e-5, 100, 1000,
                               remat=remat, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    losses, ms = [], []
    for px, ids in batches[:TRAIN_TIMED_STEPS]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, px, ids)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated(device)
    return state, step, losses, ms, peak


def _step_profile(state, step, batch) -> dict:
    """torch.profiler over two steps: device ms by kernel class and the
    busy share against the wall of two unprofiled steps."""
    px, ids = batch
    box = [state]

    def one():
        box[0], _ = step(box[0], px, ids)

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 2
    kernels, wall_prof = _profiled(one, 2)
    busy = sum(ms for _, ms, _ in kernels)
    classes: dict = {}
    for name, ms, _ in kernels:
        cls = _kernel_class(name)
        classes[cls] = classes.get(cls, 0.0) + ms
    return {"wall_ms_per_step": wall, "wall_ms_per_step_profiled": wall_prof,
            "device_ms_per_step": busy, "device_busy_share": busy / wall,
            "device_ms_by_class": dict(sorted(classes.items(),
                                              key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:90], "ms": ms, "calls": c}
                            for n, ms, c in kernels[:10]]}


def _train_cli(pairs: str, ckpt: str, tmp: str) -> dict:
    """python -m clipx_torch.cli.train at ViT-B/32 and its defaults (batch
    64, lr 1e-5, warmup 100) in a process of its own: SIGTERM once it has
    logged step TRAIN_CLI_STEPS (exit 0, 'SIGTERM: stopping after step N',
    checkpoint and final params), then its main() with --resume for
    TRAIN_RESUME_STEPS more steps from step N; the checkpoint's optimizer
    count must follow the step. Returns both runs' lines and the img/s the
    first logged."""
    import select

    from clipx_torch.cli import train as train_cli

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = [sys.executable, "-u", "-m", "clipx_torch.cli.train", pairs,
            "--model", TRAIN_MODEL, "--checkpoint-dir", ckpt,
            "--log-every", "10", "--checkpoint-every", "100000"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(base + ["--steps", "100000"], cwd=tmp, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        out = ""
        while max(map(int, re.findall(r"step (\d+)/", out)),
                  default=0) < TRAIN_CLI_STEPS:
            check(time.perf_counter() - t0 < 600 and proc.poll() is None,
                  f"the train CLI did not reach step {TRAIN_CLI_STEPS}:\n"
                  f"{out}")
            if select.select([proc.stdout], [], [], 1.0)[0]:
                out += proc.stdout.readline()
        logged_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=300)
        out += rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    first_s = time.perf_counter() - t0
    m = re.search(r"SIGTERM: stopping after step (\d+)", out)
    check(proc.returncode == 0 and m is not None
          and f"final params -> {ckpt}" in out,
          f"the train CLI's SIGTERM exit ({proc.returncode}):\n{out}")
    stopped = int(m.group(1))
    rates = [float(r.replace(",", "")) for r in re.findall(
        r"step \d+/\d+ loss [0-9.]+ acc [0-9.]+ \(([0-9,]+) img/s\)", out)]
    # the resume runs in this process: the same main(), no second start
    t0 = time.perf_counter()
    total = stopped + TRAIN_RESUME_STEPS
    rc, rout = _quiet(train_cli.main, base[4:] + ["--steps", str(total),
                                                  "--resume"])
    resume_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    check(rc == 0 and f"at step {stopped}" in rout
          and f"step {total}/{total}" in rout,
          f"--resume from step {stopped} failed:\n{rout}")
    with np.load(os.path.join(ckpt, "latest")) as z:
        check(int(z["step"]) == int(z["count"]) == total,
              f"the resumed checkpoint holds step {int(z['step'])}, "
              f"count {int(z['count'])}, not {total}")
    return {"lines": out.splitlines(), "resume_lines": rout.splitlines(),
            "img_per_s_logged": rates, "stopped_after_step": stopped,
            "run_s": first_s, "to_step_s": logged_s, "resume_s": resume_s}


def phase_train(device) -> dict:
    """Contrastive training at ViT-B/32 full width (seeded init, f32): the
    card against the CPU on one batch of 8 for 3 steps; CUDA-event step ms,
    the allocator's peak and a profile of one step at batch 64; --remat on
    the same 10 batches (loss within 1e-6, peak lower); the CLI with
    SIGTERM and --resume, its params.npz loaded into the Encoder; then RN50
    (10 timed steps at batch 64, one card-vs-CPU step at batch 4). No
    kernel of the port's launches (checked by the caller)."""
    from clipx_torch import config as config_lib
    from clipx_torch.cli.train import find_pairs
    from clipx_torch.models import convert
    from clipx_torch.runtime.encoder import Encoder

    info = {"phase": "train", "model": TRAIN_MODEL}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        folder = _pair_folder(tmp)
        pairs = _quiet(find_pairs, folder)[0]
        check(len(pairs) == TRAIN_PAIRS, f"{len(pairs)} pairs")
        cfg = config_lib.get_config(TRAIN_MODEL)
        tree = convert.init_params(cfg, SEED)
        info["setup_s"] = time.perf_counter() - t0
        legs = info["leg_seconds"] = {}
        t0 = time.perf_counter()
        info["card_vs_cpu"] = _card_vs_cpu(
            TRAIN_MODEL, tree, pairs, TRAIN_CPU_BATCH, TRAIN_CPU_STEPS, 1,
            device, TRAIN_UPDATE_ATOL, TRAIN_UPDATE_RL2)
        cpu_run = info["card_vs_cpu"].pop("_cpu")
        legs["card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = _batches(pairs, 224, TRAIN_BATCH, TRAIN_TIMED_STEPS,
                           device)
        state, step, losses, ms, peak = _timed_steps(TRAIN_MODEL, tree,
                                                     batches, device)
        info["step"] = {"batch": TRAIN_BATCH, "losses": losses,
                        "step_ms": ms, "step_ms_median": statistics.median(
                            ms[2:]),
                        "img_per_s": TRAIN_BATCH * 1e3
                        / statistics.median(ms[2:]),
                        "peak_allocated_bytes": peak,
                        "profile": _step_profile(state, step, batches[0])}
        del state, step
        torch.cuda.empty_cache()
        state, step, rlosses, rms, rpeak = _timed_steps(
            TRAIN_MODEL, tree, batches, device, remat=True)
        del state, step
        torch.cuda.empty_cache()
        worst = max(abs(a - b) / abs(b) for a, b in zip(rlosses, losses))
        check(worst <= REMAT_LOSS_RTOL,
              f"--remat losses differ by {worst} relative")
        check(rpeak < peak, f"--remat peak {rpeak} >= {peak}")
        info["remat"] = {"losses": rlosses, "max_rel_loss_diff": worst,
                         "peak_allocated_bytes": rpeak,
                         "step_ms_median": statistics.median(rms[2:])}
        legs["timed_profile_remat"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "ckpts")
        info["cli"] = _train_cli(folder, ckpt, tmp)
        legs["cli"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        enc = Encoder.create(TRAIN_MODEL, device=device,
                             checkpoint=os.path.join(ckpt, "params.npz"))
        emb = enc.encode_texts(["a red square"])
        _unit_rows(emb, cfg.embed_dim, "the trained params' text embedding")
        del enc
        legs["encoder_load"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        rn_cfg = config_lib.get_config(TRAIN_RN)
        rn_tree = convert.init_params(rn_cfg, SEED)
        info["rn50"] = {"card_vs_cpu": _card_vs_cpu(
            TRAIN_RN, rn_tree, pairs, TRAIN_RN_CPU_BATCH, 1, 0, device,
            None, TRAIN_RN_UPDATE_RL2)}
        del info["rn50"]["card_vs_cpu"]["_cpu"]
        state, step, losses, ms, peak = _timed_steps(TRAIN_RN, rn_tree,
                                                     batches, device)
        check(all(np.isfinite(losses)), f"RN50 losses {losses}")
        info["rn50"].update(
            batch=TRAIN_BATCH, losses=losses, step_ms=ms,
            step_ms_median=statistics.median(ms[2:]),
            img_per_s=TRAIN_BATCH * 1e3 / statistics.median(ms[2:]),
            peak_allocated_bytes=peak,
            profile=_step_profile(state, step, batches[0]))
        del state, step
        torch.cuda.empty_cache()
        legs["rn50"] = time.perf_counter() - t0
    emit(info)
    # what phase tp compares with and reuses
    return {"info": info, "tree": tree, "batches": batches,
            "cpu_run": cpu_run}


# ---------------------------------------------------------------------------
# phase tp: tensor parallelism (clipx_torch/parallel/tensor.py)
# ---------------------------------------------------------------------------

TP_AXES = {"dp": 2, "tp": 2}   # on one card: cuda:0 listed 4 times
TP_NCCL_STEPS = 2
TP_REMAT_STEPS = 3   # of phase train's 10 batches: --remat's losses


# split heads: ViT-B/32's 12 vision heads over 8 tp positions (1.5 heads
# a position) and its 8 text heads (1 a position), cuda:0 listed 8 times
SPLIT_AXES = {"dp": 1, "tp": 8}
SPLIT_IMAGES = 256         # of phase encode's images
SPLIT_BATCH, SPLIT_STEPS = 16, 2
# the split-head TP encode against phase encode's single-device bf16
# embeddings: the same bf16 products in another order (the whole-heads
# leg measured >= 0.99995)
SPLIT_COS_MIN = 0.9999


def _tp_encode_leg(mesh, tree, images: np.ndarray, embs: np.ndarray,
                   cpu_ref: np.ndarray, n: int = N_IMAGES,
                   cos_min: float = COS_MIN) -> dict:
    """ViT-B/32 (phase train's tree: the seed's, as phase encode's) through
    Encoder(mesh=..., tp="tp") on the first ``n`` of phase encode's images
    at batch 128 (attn_impl "pallas" asked for, "plain" taken): cosine (at
    least ``cos_min``) against phase encode's single-device bf16
    embeddings of each and the CPU's f32 encode of the first CPU_CHECK
    (COS_MIN); img/s; a text encode."""
    from clipx_torch import config as config_lib
    from clipx_torch.runtime.encoder import Encoder

    t0 = time.perf_counter()
    enc = Encoder(config_lib.get_config(TRAIN_MODEL), tree, mesh=mesh,
                  tp="tp", attn_impl="pallas")
    check(enc.attn_impl == "plain", f"tp took attn_impl {enc.attn_impl}")
    enc.warmup(buckets=(BATCH,))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = np.concatenate([enc.encode_images(images[i: i + BATCH])
                          for i in range(0, n, BATCH)])
    secs = time.perf_counter() - t0
    _unit_rows(out, enc.embed_dim, "the TP encode")
    cos = _cos_min(out, embs[:n])
    cos_cpu = _cos_min(out[:CPU_CHECK], cpu_ref)
    check(cos >= cos_min and cos_cpu >= COS_MIN,
          f"TP encode cosine {cos} vs the single-device encode, {cos_cpu} "
          "vs the CPU's f32")
    _unit_rows(enc.encode_texts(["a photo of a cat"]), enc.embed_dim,
               "the TP text encode")
    del enc
    torch.cuda.empty_cache()
    return {"mesh": dict(mesh.axes), "devices": len(set(mesh.devices)),
            "images": n, "batch": BATCH, "setup_s": setup_s,
            "seconds": secs, "img_per_s": n / secs,
            "cos_min_vs_single_device": cos, "cos_min_vs_cpu_f32": cos_cpu,
            "cos_tolerance": cos_min, "cos_tolerance_cpu": COS_MIN}


def _tp_train_leg(mesh, device, train: dict) -> dict:
    """The dp x tp step at ViT-B/32, f32 with TF32 off: 3 steps of phase
    train's batch of 8 against its single-device CPU steps (phase train's
    tolerances, every replica bitwise), TRAIN_TIMED_STEPS timed steps of
    its batches of 64 (CUDA-event median, allocator peak), and --remat on
    the first TP_REMAT_STEPS of them (losses within REMAT_LOSS_RTOL)."""
    tree, batches = train["tree"], train["batches"]
    legs = {}
    t0 = time.perf_counter()
    out = {"card_vs_cpu": _card_vs_cpu(
        TRAIN_MODEL, tree, None, TRAIN_CPU_BATCH, TRAIN_CPU_STEPS, 1,
        device, TRAIN_UPDATE_ATOL, TRAIN_UPDATE_RL2, mesh=mesh,
        cpu_run=train["cpu_run"])}
    del out["card_vs_cpu"]["_cpu"]
    legs["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, step, losses, ms, peak = _timed_steps(TRAIN_MODEL, tree, batches,
                                                 device, mesh=mesh)
    legs["timed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    del state, step
    torch.cuda.empty_cache()
    _, _, rlosses, rms, rpeak = _timed_steps(
        TRAIN_MODEL, tree, batches[:TP_REMAT_STEPS], device, remat=True,
        mesh=mesh)
    torch.cuda.empty_cache()
    legs["remat"] = time.perf_counter() - t0
    worst = max(abs(a - b) / abs(b) for a, b in zip(rlosses, losses))
    check(worst <= REMAT_LOSS_RTOL,
          f"dp x tp --remat losses differ by {worst} relative")
    median = statistics.median(ms[2:])
    single = train["info"]["step"]
    out.update(batch=TRAIN_BATCH, losses=losses, step_ms=ms,
               step_ms_median=median,
               img_per_s=TRAIN_BATCH * 1e3 / median,
               peak_allocated_bytes=peak,
               single_device_step_ms_median=single["step_ms_median"],
               single_device_peak_allocated_bytes=single[
                   "peak_allocated_bytes"],
               step_ms_ratio_to_single_device=median
               / single["step_ms_median"],
               remat={"losses": rlosses, "max_rel_loss_diff": worst,
                      "step_ms_median": statistics.median(rms[2:]),
                      "peak_allocated_bytes": rpeak}, leg_seconds=legs)
    return out


def _tp_split_leg(mesh, device, train: dict, encoded: dict) -> dict:
    """ViT-B/32 over a tp size that splits the vision heads
    (parallel/tensor.py's split-head attention): the TP encode of
    SPLIT_IMAGES of phase encode's images (cosine >= SPLIT_COS_MIN against
    its single-device embeddings); 3 f32 steps of phase train's batch of 8
    against its CPU run (phase train's tolerances, every replica bitwise);
    SPLIT_STEPS steps of the first SPLIT_BATCH rows of its batches against
    the single-device step on the card (losses within TRAIN_LOSS_RTOL),
    CUDA-event ms of each; then one more split step under a CUDA-only
    profile, whose device ms over its own wall is the card's busy share."""
    from clipx_torch import config as config_lib

    tree = train["tree"]
    out, legs = {}, {}
    t0 = time.perf_counter()
    out["encode"] = _tp_encode_leg(mesh, tree, encoded["images"],
                                   encoded["embs"], encoded["cpu_ref"],
                                   SPLIT_IMAGES, SPLIT_COS_MIN)
    out["encode"]["single_device_img_per_s"] = encoded["img_per_s"]
    legs["encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["card_vs_cpu"] = _card_vs_cpu(
        TRAIN_MODEL, tree, None, TRAIN_CPU_BATCH, TRAIN_CPU_STEPS, 1,
        device, TRAIN_UPDATE_ATOL, TRAIN_UPDATE_RL2, mesh=mesh,
        cpu_run=train["cpu_run"])
    del out["card_vs_cpu"]["_cpu"]
    legs["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = [(px[:SPLIT_BATCH], ids[:SPLIT_BATCH])
               for px, ids in train["batches"][:SPLIT_STEPS]]
    runs = {}
    for name, where in (("split", mesh), ("single", None)):
        t1 = time.perf_counter()
        state, step = _train_setup(TRAIN_MODEL, tree, device, 1e-5, 100,
                                   1000, mesh=where)
        legs[f"{name}_setup"] = time.perf_counter() - t1
        losses, ms = [], []
        for px, ids in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, px, ids)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
        runs[name] = {"losses": losses, "step_ms": ms}
        if where is not None:
            runs[name]["replica_trees_bitwise"] = _replicas_bitwise(
                state.params)
            box = [state]

            def one():
                box[0], _ = step(box[0], *batches[-1])

            t1 = time.perf_counter()
            kernels, wall = _profiled(one, 1, host_ops=False)
            legs["profile"] = time.perf_counter() - t1
            busy = sum(t for _, t, _ in kernels)
            check(busy > 0, "torch.profiler saw no device time")
            runs[name].update(profiled_step_ms=wall, device_ms=busy)
            del box
        del state, step
        torch.cuda.empty_cache()
    split, single = runs["split"], runs["single"]
    for a, b in zip(split["losses"], single["losses"]):
        check(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b),
              f"split-head loss {a} vs the single device's {b}")
    legs["steps"] = time.perf_counter() - t0
    out["steps"] = {
        "batch": SPLIT_BATCH, "steps": SPLIT_STEPS, **split,
        "single_device": single,
        "device_busy_share": split["device_ms"]
        / split["profiled_step_ms"],
        "step_ms_ratio_to_single_device":
            split["step_ms"][-1] / single["step_ms"][-1]}
    cfg = config_lib.get_config(TRAIN_MODEL)
    check(cfg.vision.heads % mesh.axes["tp"] != 0,
          f"{mesh.axes} gives each position whole vision heads")
    out.update(mesh=dict(mesh.axes), devices=len(set(mesh.devices)),
               vision_heads_per_position=cfg.vision.heads / mesh.axes["tp"],
               text_heads_per_position=cfg.text.heads / mesh.axes["tp"],
               leg_seconds=legs)
    return out


def _tp_process_leg(device, train: dict, losses) -> dict:
    """TP_NCCL_STEPS dp x tp steps over a mesh whose positions (cuda:0 four
    times) carry rank 0 of a one-rank NCCL group, so every collective runs
    through the process group; their losses and grad norms against the
    in-process timed run's first steps (the same batches and settings)."""
    import socket

    import torch.distributed as dist

    from clipx_torch.parallel import distributed
    from clipx_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{port}", num_processes=1,
                           process_id=0, device=str(device))
    try:
        backend = "nccl" if device.type == "cuda" else "gloo"
        check(dist.get_backend() == backend, f"the group is not {backend}")
        devices, ranks = distributed.global_devices([device] * 4)
        mesh = make_mesh(TP_AXES, devices, ranks)
        check(mesh.process_group, "the mesh does not span the group")
        state, step = _train_setup(TRAIN_MODEL, train["tree"], device, 1e-5,
                                   100, 1000, mesh=mesh)
        got = []
        for px, ids in train["batches"][:TP_NCCL_STEPS]:
            state, m = step(state, px, ids)
            got.append(float(m["loss"]))
        del state, step
    finally:
        distributed.shutdown()
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "the process group was not destroyed")
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, losses))
    check(worst <= REMAT_LOSS_RTOL,
          f"the NCCL group's losses {got} differ from the in-process "
          f"{losses[:TP_NCCL_STEPS]}")
    return {"backend": backend, "ranks": 1, "steps": TP_NCCL_STEPS,
            "losses": got, "max_rel_loss_diff": worst,
            "bitwise": got == losses[:TP_NCCL_STEPS],
            "seconds": time.perf_counter() - t0}


def phase_tp(device, train: dict, encoded: dict) -> dict:
    """Tensor parallelism at ViT-B/32 full width over TP_AXES on cuda:0
    listed 4 times (one card plays every position: not multi-GPU numbers),
    and with more than one GPU visible over {"dp": n / 2, "tp": 2} of real
    GPUs too: the TP encode (_tp_encode_leg), the dp x tp train step
    (_tp_train_leg), one NCCL rank (_tp_process_leg); then split heads over
    SPLIT_AXES of cuda:0 listed 8 times, and of eight GPUs where eight are
    visible (_tp_split_leg). No kernel of the
    port launches: clipx's TP paths reach no Pallas kernel (its sharded
    step and its tp Encoder take plain attention), and the port's follow
    (checked by the caller)."""
    from clipx_torch.parallel.mesh import make_mesh, visible_devices

    info = {"phase": "tp", "model": TRAIN_MODEL, "mesh": TP_AXES,
            "positions": "cuda:0 listed 4 times"}
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    mesh = make_mesh(TP_AXES, [device] * 4)
    info["encode"] = timed("encode", _tp_encode_leg, mesh, train["tree"],
                           encoded["images"], encoded["embs"],
                           encoded["cpu_ref"])
    info["encode"]["single_device_img_per_s"] = encoded["img_per_s"]
    info["train"] = timed("train", _tp_train_leg, mesh, device, train)
    info["process"] = timed("process", _tp_process_leg, device, train,
                            info["train"]["losses"])
    info["split_heads"] = timed("split_heads", _tp_split_leg,
                                make_mesh(SPLIT_AXES, [device] * 8), device,
                                train, encoded)
    n = torch.cuda.device_count()
    if n > 1 and n % 2 == 0:
        gpus = visible_devices("cuda")
        real = make_mesh({"dp": n // 2, "tp": 2}, gpus)
        info["every_gpu"] = {
            "gpus": n,
            "encode": timed("every_gpu_encode", _tp_encode_leg, real,
                            train["tree"], encoded["images"],
                            encoded["embs"], encoded["cpu_ref"]),
            "train": timed("every_gpu_train", _tp_train_leg, real, device,
                           train)}
    if n >= 8:
        info["split_heads_every_gpu"] = timed(
            "split_heads_every_gpu", _tp_split_leg,
            make_mesh(SPLIT_AXES, visible_devices("cuda")[:8]), device,
            train, encoded)
    info["seconds"] = seconds
    emit(info)
    return info


# ---------------------------------------------------------------------------
# phase tools: the capacity and maintenance tools (clipx_torch/tools/)
# ---------------------------------------------------------------------------

SYNTH_ROWS = 1_000_000     # make_synth_index: 1M x 512, as phase search's
DUPE_ROWS, DUPE_GROUPS = 200_000, 500
DIRECT_ROWS, DIRECT_DIM = 120_000, 64   # build_codes_direct (tests' size)
DIRECT_QUERIES = 1024


def _tool(fn, argv):
    """(rc, stdout) of a tool's main(argv), and its seconds."""
    t0 = time.perf_counter()
    rc, out = _quiet(fn, argv)
    return rc, out, time.perf_counter() - t0


def _planted_dupes(tmp: str):
    """DUPE_ROWS seeded unit rows of width DIM with DUPE_GROUPS planted
    groups of 2 to 6 near-copies (noise 1e-3), written as images.index
    plus an idx_db; returns the directory and the planted groups."""
    from clipx_torch.search.engine import IndexWriter
    from clipx_torch.store.kv import open_env

    rng = np.random.default_rng(SEED + 12)
    rows = rng.standard_normal((DUPE_ROWS, DIM), dtype=np.float32)
    order = rng.permutation(DUPE_ROWS)
    groups, at = [], 0
    for g in range(DUPE_GROUPS):
        size = 2 + g % 5
        ids = order[at: at + size]
        at += size
        rows[ids[1:]] = rows[ids[0]] + 1e-3 * rng.standard_normal(
            (size - 1, DIM), dtype=np.float32) * np.linalg.norm(rows[ids[0]])
        groups.append(frozenset(int(i) for i in ids))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    d = os.path.join(tmp, "dupes")
    os.makedirs(d)
    writer = IndexWriter(os.path.join(d, "images.index"), DUPE_ROWS, DIM)
    writer.write(rows)
    writer.close()
    env = open_env(os.path.join(d, "vectors.lmdb"))
    db = env.open_db(b"idx_db")
    with env.begin(db=db, write=True) as txn:
        for i in range(DUPE_ROWS):
            txn.put(str(i).encode(), f"/dupes/img{i:06d}.jpg".encode())
    env.close()
    return d, groups


def _tool_process(module: str, argv, tmp: str, name: str):
    """python -m clipx_torch.tools.<module> argv, in the background, its
    output to tmp/<name>.log."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"clipx_torch.tools.{module}", *argv],
        cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def _finish(proc, tmp: str, name: str) -> str:
    """Wait for a _tool_process (its exit code checked) and return its
    output."""
    rc = proc.wait(timeout=900)
    proc.log.close()
    with open(os.path.join(tmp, f"{name}.log")) as f:
        out = f.read()
    check(rc == 0, f"{name}: exit {rc}\n{out}")
    return out


def phase_tools(device, keep: str) -> dict:
    """The port's tools on the card. make_synth_index at 1,000,000 x 512
    and build_codes_direct at DIRECT_ROWS x DIRECT_DIM (host work, one core
    and the host's BLAS threads) run in processes of their own while
    find_dupes searches 200,000 rows with planted groups (found = planted)
    and kv_tool stat, verify and compact phase search's store; then
    kv_tool drop-f32 refused on the synthetic index (no codes file);
    load_timing int8 cold, then warm with --query, on it; load_timing pq
    --query on phase coded's pq deployment (B11), then drop-f32 on it; the
    direct build booted codes-only (``_direct_checks``)."""
    from clipx_torch.ops import packed_sdpa as ps
    from clipx_torch.tools import find_dupes, kv_tool, load_timing

    info = {"phase": "tools"}
    with tempfile.TemporaryDirectory() as tmp:
        synth = os.path.join(tmp, "synth")
        direct = os.path.join(tmp, "direct")
        procs = {"make_synth_index": _tool_process(
                     "make_synth_index", [synth, "--rows", str(SYNTH_ROWS)],
                     tmp, "make_synth_index"),
                 "build_codes_direct": _tool_process(
                     "build_codes_direct", [
                         direct, "--rows", str(DIRECT_ROWS), "--dim",
                         str(DIRECT_DIM), "--dsub", "2", "--store", "none",
                         "--json", os.path.join(tmp, "direct.json")],
                     tmp, "build_codes_direct")}
        try:
            d, planted = _planted_dupes(tmp)
            rc, out, secs = _tool(find_dupes.main, [
                "--db", os.path.join(d, "vectors.lmdb"),
                "--index", os.path.join(d, "images.index"),
                "--threshold", "0.99"])
            found = []
            for line in out.splitlines():
                if line.startswith("# group of "):
                    found.append(set())
                elif line.strip():
                    found[-1].add(int(line.split("\t")[0]))
            found = [frozenset(g) for g in found]
            check(rc == 0 and set(found) == set(planted)
                  and len(found) == len(planted),
                  f"find_dupes found {len(found)} groups, planted "
                  f"{len(planted)}; equal: {set(found) == set(planted)}")
            info["find_dupes"] = {"rows": DUPE_ROWS, "groups": len(found),
                                  "seconds": secs}

            store = os.path.join(keep, "vectors.lmdb")
            kv = {}
            for cmd in ("stat", "verify", "compact", "stat"):
                rc, out, secs = _tool(kv_tool.main, [cmd, store])
                check(rc == 0, f"kv_tool {cmd}: {rc}\n{out}")
                kv.setdefault(cmd, []).append(out.strip().splitlines()[-1])
            check(kv["verify"][0] == "verify: OK"
                  and kv["compact"][0].startswith("compacted: "),
                  f"kv_tool: {kv}")
            info["kv_tool"] = kv

            out = _finish(procs.pop("make_synth_index"), tmp,
                          "make_synth_index")
            m = re.search(r"in (\d+)s; content_hash=", out)
            check(m is not None, f"make_synth_index:\n{out}")
            index = os.path.join(synth, "images.index")
            info["make_synth_index"] = {"rows": SYNTH_ROWS, "dim": DIM,
                                        "seconds": int(m.group(1)),
                                        "bytes": os.path.getsize(index)}
            rc, out, _ = _tool(kv_tool.main, ["drop-f32", "--index", index])
            check(rc == 2
                  and out.startswith("REFUSING: no readable codes file"),
                  f"drop-f32 without a codes file: {rc}\n{out}")
            info["drop_f32_refused"] = out.splitlines()[0][:80]
            lt = {}
            for leg, argv in (
                    ("int8_cold", ["--index", index, "--cold"]),
                    ("int8_warm", ["--index", index, "--query"]),
                    ("pq_warm", ["--index",
                                 os.path.join(keep, "images.index"),
                                 "--corpus-dtype", "pq", "--query"])):
                jpath = os.path.join(tmp, f"{leg}.json")
                before = ps.launch_counts()["pq_scan_scores"]
                rc, out, secs = _tool(load_timing.main,
                                      argv + ["--json", jpath])
                check(rc == 0, f"load_timing {leg}: {rc}\n{out}")
                with open(jpath) as f:
                    lt[leg] = json.load(f)
                lt[leg]["seconds"] = secs
                lt[leg]["b11_launches"] = (
                    ps.launch_counts()["pq_scan_scores"] - before)
                check(lt[leg]["platform"] == "cuda",
                      f"load_timing {leg} ran on {lt[leg]['platform']}")
            check(lt["int8_cold"]["ntotal"] == SYNTH_ROWS
                  and lt["int8_warm"]["query_p50_ms"] > 0
                  and lt["pq_warm"]["b11_launches"] >= 51,
                  f"load_timing legs: {lt}")
            info["load_timing"] = lt
            rc, out, _ = _tool(kv_tool.main, [
                "drop-f32", "--index", os.path.join(keep, "images.index")])
            check(rc == 0 and "codes-only" in out, f"drop-f32 on pq:\n{out}")
            info["drop_f32"] = out.splitlines()[0]

            _finish(procs.pop("build_codes_direct"), tmp,
                    "build_codes_direct")
            with open(os.path.join(tmp, "direct.json")) as f:
                info["build_codes_direct"] = {"stats": json.load(f)}
        finally:
            for proc in procs.values():
                proc.kill()
                proc.wait(timeout=60)
                proc.log.close()
        _direct_checks(info["build_codes_direct"], direct, device)
    emit(info)
    return info


def _direct_checks(out: dict, direct: str, device) -> None:
    """The direct build booted codes-only: self-match at rank 0, within
    the top 10 and recall@50 over DIRECT_QUERIES regenerated rows, in
    tests/test_direct_build.py's bands (0.8, 0.95, 0.7)."""
    import argparse

    from clipx_torch.cli import common
    from clipx_torch.search.engine import VectorIndex
    from clipx_torch.tools import build_codes_direct

    idx = common.load_index(argparse.Namespace(
        index=os.path.join(direct, "images.index"), corpus_dtype="pq",
        search_mode="ivf", sharded="off", device=device))
    corpus = build_codes_direct.SynthCorpus(DIRECT_ROWS, DIRECT_DIM,
                                            "clustered", 0)
    qids = np.random.default_rng(3).choice(DIRECT_ROWS, DIRECT_QUERIES,
                                           replace=False)
    q = corpus.rows_at(qids)
    _, ip = idx.search(q, 50, nprobe=100)
    full = np.concatenate([corpus.chunk(c)
                           for c in range(corpus.n_chunks())])
    _, ie = VectorIndex.from_vectors(full, device=device).search(q, 50)
    self1 = float(np.mean(ip[:, 0] == qids))
    self10 = float(np.mean((ip[:, :10] == qids[:, None]).any(axis=1)))
    recall = float(np.mean([len(set(ie[i]) & set(ip[i])) / 50
                            for i in range(len(q))]))
    check(self1 >= 0.8 and self10 >= 0.95 and recall >= 0.7,
          f"direct build: self-match {self1}, top-10 {self10}, "
          f"recall@50 {recall}")
    out.update(rows=DIRECT_ROWS, dim=DIRECT_DIM, queries=DIRECT_QUERIES,
               self_match=self1, self_match_top10=self10,
               recall_at_50=recall)
    del idx
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 6: the CLIs
# ---------------------------------------------------------------------------

CLI_WORKERS = 7  # CLI legs run at once (all of them): each is processes


def phase_cli(info_env: dict) -> dict:
    """The CLIs as a user runs them, each leg in a work dir of its own:
    ViT-B/32 (then the same library as a pq index), --corpus-dtype pq
    --search-mode ivf (and a restart), --compute int8, ViT-L/14@336px,
    --preprocess device and RN50. The legs share nothing but the fixture
    photos, so CLI_WORKERS of them run at once (beside phase coded); the
    seconds each reports are under that sharing."""
    pkgs = info_env["host_packages"]
    if not (pkgs["PIL"] or pkgs["cv2"]):
        info = {"phase": "cli", "skipped": "neither PIL nor cv2 imports"}
        emit(info)
        return info
    env = dict(os.environ, PYTHONPATH=ROOT, CLIPX_NO_VIEWER="1")
    with tempfile.TemporaryDirectory() as tmp:
        photos = os.path.join(tmp, "photos") + os.sep
        os.makedirs(photos)
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

        def workdir(name):
            path = os.path.join(tmp, name)
            os.makedirs(path)
            return path

        def default_and_pq():
            work = workdir("work")
            build_s, query_s, rows, stats = _cli_build_and_query(
                ["--device", "cuda"], decode, photos, work, env, 512)
            # the same library as a pq index: the rebuild encodes no image
            # again and writes images.index.codes; the REPL loads it. Six
            # rows train six centroids per subspace, so the codes reproduce
            # the rows and each search shows the f32 run's rows (ids and
            # paths; the order of scores closer than f32 rounding may
            # differ)
            pq = ["--device", "cuda", "--corpus-dtype", "pq"]
            t0 = time.perf_counter()
            build = subprocess.run(
                [sys.executable, "-m", "clipx_torch.cli.build_index", *pq,
                 *decode, photos], cwd=work, env=env, capture_output=True,
                text=True, timeout=600)
            pq_build_s = time.perf_counter() - t0
            check(build.returncode == 0,
                  f"build_index pq failed:\n{build.stderr}")
            check("Encoding pq codes..." in build.stdout.splitlines(),
                  "build_index --corpus-dtype pq did not encode codes")
            check(os.path.exists(os.path.join(work, "images.index.codes")),
                  "build_index --corpus-dtype pq wrote no codes file")
            t0 = time.perf_counter()
            query = subprocess.run(
                [sys.executable, "-m", "clipx_torch.cli.query_index", *pq],
                cwd=work, env=env, input="a photo of a cat\ni 1\nq\n",
                capture_output=True, text=True, timeout=600)
            pq_query_s = time.perf_counter() - t0
            check(query.returncode == 0,
                  f"query_index pq failed:\n{query.stderr}")
            check("(loaded 6 pq rows from images.index.codes)"
                  in query.stderr,
                  "query_index --corpus-dtype pq did not load the codes file")
            pq_rows = [ln for ln in query.stdout.splitlines()
                       if len(ln.split()) == 3 and ln.split()[1].isdigit()
                       and ln.split()[2].startswith(photos)]
            return {"build_s": build_s, "query_s": query_s, "rows": rows,
                    "stats": stats, "pq_build_s": pq_build_s,
                    "pq_query_s": pq_query_s, "pq_rows": pq_rows}

        def ivf():
            # --search-mode ivf with pq storage: the first REPL start
            # builds the IVF index (k-means, residual codes) and writes
            # images.index.ivf and the residual codes; a second start loads
            # both ('i 1' only). Six rows make six one-row clusters, so the
            # residuals are zero and each search shows the f32 run's rows
            work = workdir("work_ivf")
            flags = ["--device", "cuda", "--corpus-dtype", "pq",
                     "--search-mode", "ivf"]
            build_s, query_s, rows, _ = _cli_build_and_query(
                flags, decode, photos, work, env, 512)
            check(os.path.exists(os.path.join(work, "images.index.ivf")),
                  "query_index --search-mode ivf wrote no images.index.ivf")
            t0 = time.perf_counter()
            again = subprocess.run(
                [sys.executable, "-m", "clipx_torch.cli.query_index",
                 *flags], cwd=work, env=env, input="p 7\ni 1\nq\n",
                capture_output=True, text=True, timeout=600)
            reload_s = time.perf_counter() - t0
            check(again.returncode == 0,
                  f"query_index ivf restart failed:\n{again.stderr}")
            check("(loaded 6 pq rows from images.index.codes)" in again.stderr
                  and "Set to probe 7 subsets." in again.stdout
                  and "Similar to " + photos in again.stdout,
                  "query_index ivf restart did not load the codes and .ivf")
            return {"build_s": build_s, "query_s": query_s, "rows": rows,
                    "reload_query_s": reload_s}

        def leg(name, flags, build_only, dim, leg_env=env):
            err = []
            build_s, query_s, rows, stats = _cli_build_and_query(
                flags, decode + build_only, photos, workdir(name), leg_env,
                dim, err)
            return {"build_s": build_s, "query_s": query_s, "rows": rows,
                    "stats": stats, "build_stderr": err[0]}

        with ThreadPoolExecutor(CLI_WORKERS) as pool:
            futures = {
                "main": pool.submit(default_and_pq),
                # the same photos at ViT-L/14@336px: the long kernels
                "long": pool.submit(leg, "work_long", [
                    "--device", "cuda", "--model", LONG_MODEL], [], 768),
                "ivf": pool.submit(ivf),
                # --compute int8 with the fused W8A8 MLP (B6)
                "int8": pool.submit(
                    leg, "work_int8", ["--device", "cuda", "--compute",
                                       "int8"], [], 512,
                    dict(env, CLIPX_FUSED_MLP_INT8="on")),
                # --preprocess device: the host decodes 256 px canvases,
                # the card resamples them (the stdout contract is the same)
                "device": pool.submit(leg, "work_device", [
                    "--device", "cuda"], ["--preprocess", "device"], 512),
                # the ResNet tower at RN50 (1024-wide embeddings)
                "rn50": pool.submit(leg, "work_rn50", [
                    "--device", "cuda", "--model", "RN50"], [], 1024),
                # phase sharded's CLI leg: both commands --sharded on (the
                # indexer's dp encode and a row-sharded index over every
                # visible GPU), the rows of the default leg
                "sharded": pool.submit(leg, "work_sharded", [
                    "--device", "cuda", "--sharded", "on"], [], 512)}
            legs = {name: f.result() for name, f in futures.items()}
    main, ivf_leg = legs["main"], legs["ivf"]
    rows = main["rows"]

    def shown(rs):  # (id, path) per search: the text query, then 'i 1'
        return [sorted(r.split()[1] + " " + r.split()[2]
                       for r in rs[i: i + 5]) for i in (0, 5)]

    check(len(main["pq_rows"]) == 10
          and shown(main["pq_rows"]) == shown(rows),
          f"pq result rows {main['pq_rows']} differ from the f32 run's {rows}")
    check(shown(ivf_leg["rows"]) == shown(rows),
          f"ivf result rows {ivf_leg['rows']} differ from the f32 run's "
          f"{rows}")
    sharded = legs["sharded"]
    gpus = torch.cuda.device_count()
    check(f"(data-parallel encode over {gpus} devices)"
          in sharded["build_stderr"],
          "build_index --sharded on did not print its data-parallel line")
    same = [a.split()[1:] == b.split()[1:]
            and abs(float(a.split()[0]) - float(b.split()[0])) <= 1e-4
            for a, b in zip(sharded["rows"], rows)]
    check(len(sharded["rows"]) == len(rows) and all(same),
          f"--sharded on result rows {sharded['rows']} differ from the "
          f"default run's {rows}")
    info = {"phase": "cli", "fixtures": backend, "workers": CLI_WORKERS,
            "build_s": main["build_s"], "query_s": main["query_s"],
            "result_rows": len(rows), "stats": main["stats"],
            "pq_build_s": main["pq_build_s"],
            "pq_query_s": main["pq_query_s"],
            "pq_result_rows": len(main["pq_rows"]),
            "ivf_pq_build_s": ivf_leg["build_s"],
            "ivf_pq_query_s": ivf_leg["query_s"],
            "ivf_pq_reload_query_s": ivf_leg["reload_query_s"],
            "ivf_pq_result_rows": len(ivf_leg["rows"]),
            "long_model": LONG_MODEL}
    info["sharded_rows_identical"] = sharded["rows"] == rows
    for name, key in (("int8", "int8"), ("long", "long"),
                      ("device", "preprocess_device"), ("rn50", "rn50"),
                      ("sharded", "sharded")):
        info.update({f"{key}_build_s": legs[name]["build_s"],
                     f"{key}_query_s": legs[name]["query_s"],
                     f"{key}_result_rows": len(legs[name]["rows"])})
        if name in ("device", "rn50"):
            info[f"{key}_stats"] = legs[name]["stats"]
    emit(info)
    return info


def _cli_build_and_query(flags, decode, photos: str, work: str, env,
                         dim: int, stderr=None):
    """build_index over the fixture photos (6 images and one broken file)
    in work (``flags`` and the build-only ``decode`` flags), then the
    scripted REPL (``flags``: a text query, 'i 1', 'q'), with the
    stdout checks of the reference contract. Returns (build seconds,
    query seconds, result rows, the build's [stats] line on stderr as
    {stage: items per second}); ``stderr``, a list, gets the build's
    stderr."""
    t0 = time.perf_counter()
    build = subprocess.run(
        [sys.executable, "-m", "clipx_torch.cli.build_index", *flags,
         *decode, photos], cwd=work, env=env, capture_output=True,
        text=True, timeout=600)
    build_s = time.perf_counter() - t0
    check(build.returncode == 0, f"build_index {flags} failed:\n"
                                 f"{build.stderr}")
    if stderr is not None:
        stderr.append(build.stderr)
    out = build.stdout
    for want in (f"CLIPing {photos}...", "Preparing index for 6 entries...",
                 f"Generating (6, {dim}) matrix...", "Saving index...",
                 "Done!"):
        check(want in out, f"build_index {flags} stdout lacks {want!r}")
    progress = out.split(f"CLIPing {photos}...")[1].split("Preparing")[0]
    check(progress.count(".") == 6 and progress.count("#") == 1,
          f"build_index {flags} progress {progress!r}")
    t0 = time.perf_counter()
    query = subprocess.run(
        [sys.executable, "-m", "clipx_torch.cli.query_index", *flags],
        cwd=work, env=env, input="a photo of a cat\ni 1\nq\n",
        capture_output=True, text=True, timeout=600)
    query_s = time.perf_counter() - t0
    check(query.returncode == 0, f"query_index {flags} failed:\n"
                                 f"{query.stderr}")
    rows = [ln for ln in query.stdout.splitlines() if len(ln.split()) == 3
            and ln.split()[1].isdigit() and ln.split()[2].startswith(photos)]
    check(query.stdout.count("Search time:") == 2,
          f"query_index {flags}: expected two searches")
    check("Similar to " + photos in query.stdout,
          f"query_index {flags}: 'i 1' did not answer")
    # 6 images, rank 0 skipped: 5 rows for the text query, 5 for 'i 1'
    check(len(rows) == 10, f"query_index {flags} printed {len(rows)} rows")
    stats = [ln for ln in build.stderr.splitlines()
             if ln.startswith("[stats] ")]
    check(len(stats) == 1, f"build_index {flags} printed no [stats] line")
    rates = {m.group(1): float(m.group(2).replace(",", ""))
             for m in re.finditer(r"(\w+): [0-9.]+s n=\d+ \(([0-9,.]+)/s\)",
                                  stats[0])}
    check(rates.get("encode_dispatch", 0) > 0,
          f"build_index {flags}: no encode rate in {stats[0]!r}")
    return build_s, query_s, rows, rates


# the work that runs in threads beside the phases from coded to resnet;
# phase quality runs in a process of its own (``--phase quality``), its
# launches counted there
BESIDE = ("pq_encode", "ivf_residual_build", "cli", "quality")
PHASES_APART = {"quality": phase_quality}


def _wall(fn, *args):
    """(fn(*args), its seconds)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _phase_apart(name: str) -> dict:
    """Phase ``name`` in a process of its own (this script with --phase
    name), its launch counts set to 0 there just before the phase and read
    just after. Its lines are printed here; returns its launch counts."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", name],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    sys.stderr.write(proc.stderr)
    check(proc.returncode == 0, f"phase {name} failed in its process "
          f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        emit(line)
    return json.loads(lines[-1])["launches"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and (len(argv) != 2 or argv[0] != "--phase"
                 or argv[1] not in PHASES_APART):
        print("usage: python3 chip_smoke.py [--phase "
              + "|".join(PHASES_APART) + "]", file=sys.stderr)
        return 2
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
    if argv:
        from clipx_torch.ops import packed_sdpa as ps

        ps.reset_launches()
        PHASES_APART[argv[1]]()
        emit({"launches": kernel_counts()})
        return 0
    # phase search's store and phase coded's pq deployment, for phase tools
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as keep:
        return _run_phases(device, keep)


def _run_phases(device, keep: str) -> int:
    from clipx_torch.ops import packed_sdpa as ps

    start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    info = phase_env()
    results = timed("kernels", phase_kernels, device)
    enc, setup_s = make_encoder(device)
    emit({"phase": "encoder_setup", "seconds": setup_s})
    images = np.random.default_rng(SEED).integers(
        0, 256, (N_IMAGES, 224, 224, 3), dtype=np.uint8)
    # the main path: counts from 0 just before it, read just after
    ps.reset_launches()
    encoded = timed("encode", phase_encode, enc, images)
    timed("text", phase_text, enc)
    search = timed("search", phase_search, encoded["embs"], device, keep)
    search["rows"] = search["index"].vectors()
    # minutes of host work that time nothing on the card run beside the
    # phases from coded to resnet (module docstring); each job's seconds
    # are its own wall
    beside = ThreadPoolExecutor(len(BESIDE), thread_name_prefix="beside")
    try:
        jobs = {
            "ivf_residual_build": beside.submit(
                _residual_build, search["rows"][-IVF_PQ_ROWS:], device,
                keep),
            "cli": beside.submit(_wall, phase_cli, info),
            "quality": beside.submit(_wall, _phase_apart, "quality")}
        timed("coded", phase_coded, search, device, keep, beside,
              (jobs["cli"], jobs["quality"]))
        launches = kernel_counts()
        emit({"phase": "main_path_launches", "launches": launches})
        check(launches["fused_attn_block"] > 0
              and launches["packed_sdpa"] > 0
              and launches["pq_scan_scores"] > 0,
              "a kernel of the main path was never launched")
        check(not any(launches[n] for n in OPT_IN_KERNELS),
              "the default path launched an opt-in kernel")
        _, seconds["cli"] = jobs["cli"].result()
        # the quality gate's path, in its process of its own: B11 (flat and
        # IVF pq), B1 and B2 (the drift leg's build and one-image encodes)
        quality, seconds["quality"] = jobs["quality"].result()
        paths = [launches, quality]
        emit({"phase": "quality_path_launches", "launches": quality})
        check({name for name, n in quality.items() if n}
              == {"fused_attn_block", "packed_sdpa", "pq_scan_scores"},
              f"the quality gate launched {quality}, not B1, B2 and B11")
        timed("profile", phase_profile, enc, images, encoded["info"])
        # the canvas path (--preprocess device): counts from 0 just before
        # it, read just after
        ps.reset_launches()
        timed("preprocess", phase_preprocess, enc, encoded)
        paths.append(kernel_counts())
        emit({"phase": "preprocess_path_launches", "launches": paths[-1]})
        check({name for name, n in paths[-1].items() if n}
              == {"fused_attn_block", "packed_sdpa"},
              f"the canvas path launched {paths[-1]}, not B1 and B2 alone")
        # the opt-in routes: counts from 0 just before each, read just
        # after
        ps.reset_launches()
        timed("int8", phase_int8, device, images, encoded["embs"])
        paths.append(kernel_counts())
        emit({"phase": "int8_path_launches", "launches": paths[-1]})
        ps.reset_launches()
        timed("fused", phase_fused, enc, images, encoded["cpu_ref"])
        paths.append(kernel_counts())
        emit({"phase": "fused_path_launches", "launches": paths[-1]})
        torch.cuda.empty_cache()
        # the long towers' path: counts from 0 just before it, read just
        # after
        ps.reset_launches()
        timed("long", phase_long, device)
        paths.append(kernel_counts())
        emit({"phase": "long_path_launches", "launches": paths[-1]})
        # SigLIP so400m's indexing path: counts from 0 just before it,
        # read just after (B8 alone, at D = 72)
        ps.reset_launches()
        timed("siglip", phase_siglip, device)
        paths.append(kernel_counts())
        emit({"phase": "siglip_path_launches", "launches": paths[-1]})
        check({name for name, n in paths[-1].items() if n}
              == {"fused_sdpa_long"},
              f"the SigLIP path launched {paths[-1]}, not B8 alone")
        # the ResNet towers' path: no kernel of the port's
        ps.reset_launches()
        timed("resnet", phase_resnet, device)
        paths.append(kernel_counts())
        emit({"phase": "resnet_path_launches", "launches": paths[-1]})
        check(not any(paths[-1].values()),
              f"the ResNet towers launched {paths[-1]}")
        # the host work beside ends here: phase coded_pq searches the pq
        # codes, phase ivf the residual index
        t0 = time.perf_counter()
        search["residual_build"] = jobs["ivf_residual_build"].result()
        search["pq_encode"].result()
        waited = time.perf_counter() - t0
    finally:
        beside.shutdown(cancel_futures=True)
    # the pq tier's path: counts from 0 just before it, read just after
    ps.reset_launches()
    timed("coded_pq", phase_coded_pq, search, keep)
    paths.append(kernel_counts())
    emit({"phase": "coded_pq_path_launches", "launches": paths[-1]})
    check({name for name, n in paths[-1].items() if n}
          == {"pq_scan_scores"},
          f"the pq tier launched {paths[-1]}, not B11 alone")
    # the parity gate's path, with the host to itself: counts from 0 just
    # before it, read just after
    ps.reset_launches()
    timed("parity", phase_parity, device, encoded.pop("cpu"))
    paths.append(kernel_counts())
    emit({"phase": "parity_path_launches", "launches": paths[-1]})
    check({name for name, n in paths[-1].items() if n}
          == {"fused_attn_block", "packed_sdpa"},
          f"the parity gate launched {paths[-1]}, not B1 and B2 alone")
    # the IVF path: counts from 0 just before it, read just after its
    # searches (before its kernel-versus-plain checks)
    ps.reset_launches()
    ivf = timed("ivf", phase_ivf, search, device, keep)
    paths.append(ivf["launches"])
    emit({"phase": "ivf_path_launches", "launches": paths[-1]})
    check(paths[-1]["pq_scan_scores"] > 0
          and not any(n for name, n in paths[-1].items()
                      if name != "pq_scan_scores"),
          "the IVF path launched a kernel other than B11, or not B11")
    # the HTTP service's path: counts from 0 before each of its parts,
    # read after each
    serve = timed("serve", phase_serve, enc, search, images, info["card"])
    paths.append(serve["launches"])
    emit({"phase": "serve_path_launches", "launches": paths[-1]})
    served = {name for name, n in paths[-1].items() if n}
    check(served == {"fused_attn_block", "packed_sdpa", "pq_scan_scores"},
          f"the service's path launched {sorted(served)}, not B1, B2 and "
          "B11 alone")
    del ivf, serve
    torch.cuda.empty_cache()
    # the sharded path (clipx_torch/parallel): counts from 0 just before
    # it, read just after its legs (before its B11-versus-plain check)
    ps.reset_launches()
    sharded = timed("sharded", phase_sharded, device, search, images,
                    encoded["embs"])
    paths.append(sharded["launches"])
    emit({"phase": "sharded_path_launches", "launches": paths[-1]})
    check({name for name, n in paths[-1].items() if n}
          == {"fused_attn_block", "pq_scan_scores"},
          f"the sharded path launched {paths[-1]}, not B1 (the dp encode) "
          "and B11 (the pq shards) alone")
    # what phase tp compares its TP encode with
    tp_inputs = {"images": images, "embs": encoded["embs"],
                 "cpu_ref": encoded["cpu_ref"],
                 "img_per_s": encoded["info"]["img_per_s"]}
    del search, sharded, enc, images, encoded
    torch.cuda.empty_cache()
    # training's path: no kernel of the port's (clipx's step reaches none)
    ps.reset_launches()
    train = timed("train", phase_train, device)
    paths.append(kernel_counts())
    emit({"phase": "train_path_launches", "launches": paths[-1]})
    check(not any(paths[-1].values()),
          f"the training path launched {paths[-1]}")
    # the tensor-parallel paths: no kernel of the port's either (clipx's
    # TP encode and sharded step take plain attention)
    ps.reset_launches()
    timed("tp", phase_tp, device, train, tp_inputs)
    paths.append(kernel_counts())
    emit({"phase": "tp_path_launches", "launches": paths[-1]})
    check(not any(paths[-1].values()),
          f"the tensor-parallel paths launched {paths[-1]}")
    del train, tp_inputs
    torch.cuda.empty_cache()
    # the tools' path: B11 alone (pq loads and the direct build's search)
    ps.reset_launches()
    timed("tools", phase_tools, device, keep)
    paths.append(kernel_counts())
    emit({"phase": "tools_path_launches", "launches": paths[-1]})
    check(paths[-1]["pq_scan_scores"] > 0
          and not any(n for name, n in paths[-1].items()
                      if name != "pq_scan_scores"),
          f"the tools launched {paths[-1]}, not B11 alone")
    total = {name: sum(p[name] for p in paths) for name in launches}
    for name, _, _ in KERNEL_TABLE:
        check(total[name] > 0,
              f"{name} was launched on no path, only in phase kernels")
    emit({"phase": "seconds", "by_phase": seconds,
          "beside": list(BESIDE), "beside_waited_s": waited,
          "total": time.perf_counter() - start,
          "empty_profiles_repeated": EMPTY_PROFILES})
    emit(kernels_line(results, total, kernels_ptxas()))
    print(info["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
