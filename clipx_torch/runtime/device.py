"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. There is
no silent move to the CPU: asking for CUDA on a machine without a visible
GPU raises.

``full_f32`` is the port's one TF32 policy: the f32 work that must be full
f32 (searches, the device resize, the training step) runs inside it, with
TF32 off for cuBLAS's matmuls and for cuDNN's convolutions, whose flag
PyTorch leaves on by default.
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
    """TF32 off on CUDA (cuBLAS and cuDNN) while any guarded work runs. The
    flags are global to the process and concurrent searches overlap (the
    HTTP service's workers), so one depth count decides: the first caller
    in saves both flags and turns TF32 off, the last one out restores
    them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = (False, False)

    @contextlib.contextmanager
    def __call__(self, device: torch.device):
        if device.type != "cuda":
            yield
            return
        with self._lock:
            if self._depth == 0:
                self._saved = (torch.backends.cuda.matmul.allow_tf32,
                               torch.backends.cudnn.allow_tf32)
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32) = self._saved


full_f32 = FullF32()
