"""What every kernel wrapper of the port shares: the launch counts and the
ctypes plumbing to its CUDA library.

``LAUNCHES`` holds one count per wrapper (one per call that launched its
kernel), so a run can show that its main path went through the kernels,
and the ``FORWARD_COUNTS``, which count forwards, not kernels: two a
family of ``runtime/graphs.py``'s CUDA graphs, ``<family>_graph``, one per
replay of a captured graph, and ``<family>_eager``, one per forward on a
CUDA device that ran eagerly. The families are the Encoder's text tower
(``text_tower_*``) and the flat pq search (``pq_search_*``, one per
``_pq_topk`` of ``VectorIndex.search``). Kernels launch from many threads
at once (the HTTP service's handlers and coalescer workers), so the counts
change only under ``_counts_lock``: ``launch`` and ``count`` increment,
``reset_launches`` zeroes and ``launch_counts`` copies.

A stream capture records kernels without running them: inside
``capturing()`` a thread's launches go into the dict it yields instead,
and each replay of the graph adds them to the counts (``count``).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Iterator

import torch

FORWARD_COUNTS = ("text_tower_graph", "text_tower_eager",
                  "pq_search_graph", "pq_search_eager")
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("fused_attn_block", "packed_sdpa", "packed_sdpa_rows", "packed_sdpa_qkv",
     "fused_sdpa_long", "fused_sdpa_long_qkv", "flash_attention",
     "pq_scan_scores", "fused_attn_sublayer", "fused_mlp", "fused_mlp_w8a8")
    + FORWARD_COUNTS, 0)

P = ctypes.c_void_p
I = ctypes.c_int  # noqa: E741 (ctypes' own name)
L = ctypes.c_longlong
F = ctypes.c_float
_fns: Dict[str, object] = {}
_counts_lock = threading.Lock()
_captured = threading.local()


def reset_launches() -> None:
    with _counts_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    """A consistent copy of every count."""
    with _counts_lock:
        return dict(LAUNCHES)


def count(counts: Dict[str, int]) -> None:
    """Add ``counts`` (name -> n) to ``LAUNCHES``."""
    with _counts_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """The launches this thread makes inside, counted in the yielded dict
    and not in ``LAUNCHES``: they are being captured into a graph."""
    _captured.counts = {}
    try:
        yield _captured.counts
    finally:
        _captured.counts = None


def c_fn(lib_name: str, sym: str, argtypes):
    """``sym`` of lib<lib_name>.so (built at first use), with argtypes set:
    c_void_p for pointers and the stream, c_int for ints, c_longlong for
    64-bit strides, c_float for a float."""
    fn = _fns.get(sym)
    if fn is None:
        from clipx_torch.ops import _build

        fn = getattr(_build.load(lib_name), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[sym] = fn
    return fn


def check_cuda(name: str, dtype, device, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, the kernel "
                             f"takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


def refuse_grad(name: str, *tensors) -> None:
    """A kernel's output has no ``grad_fn``: autograd would stop at it and
    leave the weights behind it unchanged. So while grad mode is on, an
    input that requires grad is refused, by the op's name. The public
    wrappers call this before they branch on the device, so a CPU run (the
    plain versions) fails where the card would."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the CUDA kernel has no "
            "backward; run it under torch.no_grad() or take the op's plain "
            "PyTorch route (attn_impl='plain', CLIPX_FUSED_MLP off)")


def kernel_device(name: str, x: torch.Tensor, *inputs) -> torch.device:
    """The device a kernel launches on: a CUDA tensor's. ``x`` and
    ``inputs`` are every tensor the kernel reads; one that requires grad
    is refused (``refuse_grad``). Callers send CPU tensors to the plain
    version first; anything else is refused."""
    refuse_grad(name, x, *inputs)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device} "
                         "(CUDA tensors launch the kernel, CPU tensors "
                         "run the plain version)")
    return x.device


def launch(name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point on the device's current stream (passed last),
    raise on a launch error, and count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    captured = getattr(_captured, "counts", None)
    if captured is not None:
        captured[name] = captured.get(name, 0) + 1
    else:
        count({name: 1})
