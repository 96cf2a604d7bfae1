"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. There is
no silent move to the CPU: asking for CUDA on a machine without a visible
GPU raises.
"""

from __future__ import annotations

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
