"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. There is
no silent move to the CPU: asking for CUDA on a machine without a visible
GPU raises.

``full_f32`` is the port's one TF32 policy: the f32 products that must be
full f32 (searches, the device resize) run inside it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and no GPU is
    visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: clipx_torch runs on the GPU unless "
            "the CPU is requested (device='cpu', or --device cpu)")
    if dev.type not in DEVICES:
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


class FullF32:
    """TF32 off on CUDA while any guarded product runs. The flag is global
    to the process and concurrent searches overlap (the HTTP service's
    workers), so one depth count decides: the first caller in saves the
    flag and turns TF32 off, the last one out restores it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = False

    @contextlib.contextmanager
    def __call__(self, device: torch.device):
        if device.type != "cuda":
            yield
            return
        with self._lock:
            if self._depth == 0:
                self._saved = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = False
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    torch.backends.cuda.matmul.allow_tf32 = self._saved


full_f32 = FullF32()
