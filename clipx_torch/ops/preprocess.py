"""Image preprocessing: the CLIP transform on the host and on the device.

Counterpart of ``clipx/ops/preprocess.py`` (own copies of the host paths):

- ``pil_resize_crop``  — PIL antialiased bicubic shorter-side resize +
                         center crop, arithmetic-identical to the
                         torchvision transform OpenAI CLIP uses;
- ``cv2_resize_crop``  — the fast host path (INTER_AREA down, INTER_CUBIC
                         up), the indexer's default;
- ``normalize_batch``  — uint8 NHWC batch -> mean/std-normalized float on
                         the batch's device.

PIL and cv2 are imported inside the functions that use them. The fully
on-device resample (``--preprocess device``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _resize_shape(w: int, h: int, target: int) -> Tuple[int, int]:
    """torchvision Resize(int) semantics: shorter side -> target."""
    if w <= h:
        return target, max(target, int(target * h / w))
    return max(target, int(target * w / h)), target


def pil_resize_crop(img, size: int = 224) -> np.ndarray:
    """PIL path: Resize -> CenterCrop -> convert to RGB, in that order (as
    CLIP's torchvision pipeline does). Returns (size, size, 3) uint8."""
    from PIL import Image

    w, h = img.size
    nw, nh = _resize_shape(w, h, size)
    img = img.resize((nw, nh), Image.BICUBIC)  # PIL bicubic is antialiased
    left = int(round((nw - size) / 2.0))
    top = int(round((nh - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def cv2_resize_crop(rgb: np.ndarray, size: int = 224) -> np.ndarray:
    """Fast host path over an RGB uint8 HWC array (e.g. from cv2.imdecode)."""
    import cv2

    h, w = rgb.shape[:2]
    nw, nh = _resize_shape(w, h, size)
    interp = cv2.INTER_AREA if (nw < w or nh < h) else cv2.INTER_CUBIC
    rgb = cv2.resize(rgb, (nw, nh), interpolation=interp)
    left = int(round((nw - size) / 2.0))
    top = int(round((nh - size) / 2.0))
    return rgb[top: top + size, left: left + size]


def normalize_batch(batch_uint8: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> normalized float NHWC on the same device:
    (x - 255 mean) * 1 / (255 std), in f32, then cast to ``dtype``."""
    dev = batch_uint8.device
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev) * 255.0
    inv = 1.0 / (torch.tensor(CLIP_STD, dtype=torch.float32,
                              device=dev) * 255.0)
    return ((batch_uint8.float() - mean) * inv).to(dtype)

