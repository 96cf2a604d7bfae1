"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each ``clipx_torch/csrc/<name>.cu`` compiles on its own into
``clipx_torch/build/lib<name>.so`` with a plain C interface (no PyTorch
headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>.so csrc/<name>.cu

A library is rebuilt when it is missing or older than any source in
``csrc/``. Builds go to a temporary name and are renamed into place, under
an ``flock``, so concurrent first uses in several processes are safe.
``build_all`` starts one ``nvcc`` per source at once; ``load_all`` does
that and loads every library (the HTTP service's warm-up, so no request
waits on ``nvcc``). The compiler's
output (``-Xptxas -v``: registers, shared memory, spills per kernel) is kept
in ``build/lib<name>.log``.

Nothing here runs at import time, and there is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
SOURCES = ("attn_block", "sdpa", "pq_scan", "mlp")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """The nvcc of the CUDA toolkit PyTorch finds ($CUDA_HOME, $CUDA_PATH,
    nvcc on PATH, or the toolkit's default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if path is None or not os.path.exists(path):
        path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels of clipx_torch cannot "
                           "be built")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _sources_mtime() -> float:
    return max(os.path.getmtime(os.path.join(CSRC_DIR, f))
               for f in os.listdir(CSRC_DIR)
               if f.endswith((".cu", ".cuh")))


def _stale(name: str) -> bool:
    path = lib_path(name)
    return (not os.path.exists(path)
            or os.path.getmtime(path) < _sources_mtime())


def _command(name: str, out: str) -> List[str]:
    return [nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out,
            os.path.join(CSRC_DIR, f"{name}.cu")]


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale library, one nvcc per source, all at once.
    Returns {name: compiler log} for the sources it built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    logs: Dict[str, str] = {}
    with open(os.path.join(BUILD_DIR, ".buildlock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        todo = [n for n in names if _stale(n)]
        procs = {}
        for n in todo:
            tmp = lib_path(n) + f".build.{os.getpid()}"
            procs[n] = (tmp, subprocess.Popen(
                _command(n, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            logs[n] = out
            with open(os.path.join(BUILD_DIR, f"lib{n}.log"), "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(n)
                if os.path.exists(tmp):
                    os.unlink(tmp)
            else:
                os.replace(tmp, lib_path(n))
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            if _stale(name):
                build_all([name])
            _libs[name] = ctypes.CDLL(lib_path(name))
        return _libs[name]


def load_all(names: Iterable[str] = SOURCES) -> None:
    """Build every stale library of ``names`` at once, then load each."""
    names = list(names)
    build_all(names)
    for name in names:
        load(name)
