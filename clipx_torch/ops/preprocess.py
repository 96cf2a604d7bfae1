"""Image preprocessing: the CLIP transform on the host and on the device.

Counterpart of ``clipx/ops/preprocess.py`` (own copies of the host paths):

- ``pil_resize_crop``  — PIL antialiased bicubic shorter-side resize +
                         center crop, arithmetic-identical to the
                         torchvision transform OpenAI CLIP uses (with
                         ``crop=False`` both sides resized to the size,
                         SigLIP's transform);
- ``cv2_resize_crop``  — the fast host path (INTER_AREA down, INTER_CUBIC
                         up), the indexer's default (``crop`` the same);
- ``normalize_batch``  — uint8 NHWC batch -> mean/std-normalized float on
                         the batch's device (CLIP's constants unless the
                         model's are given);
- ``normalize_host``   — the same on the host in numpy (the training
                         loader's);
- ``device_resize_normalize`` — the fully on-device variant for square
                         canvases (``--preprocess device``): antialiased
                         bicubic resize, clip, normalize.

PIL and cv2 are imported inside the functions that use them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from clipx_torch.runtime.device import full_f32

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _resize_shape(w: int, h: int, target: int) -> Tuple[int, int]:
    """torchvision Resize(int) semantics: shorter side -> target."""
    if w <= h:
        return target, max(target, int(target * h / w))
    return max(target, int(target * w / h)), target


def pil_resize_crop(img, size: int = 224, crop: bool = True) -> np.ndarray:
    """PIL path: Resize -> CenterCrop -> convert to RGB, in that order (as
    CLIP's torchvision pipeline does). Returns (size, size, 3) uint8.
    ``crop=False``: both sides resized to ``size`` and nothing cropped."""
    from PIL import Image

    w, h = img.size
    nw, nh = _resize_shape(w, h, size) if crop else (size, size)
    img = img.resize((nw, nh), Image.BICUBIC)  # PIL bicubic is antialiased
    left = int(round((nw - size) / 2.0))
    top = int(round((nh - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def cv2_resize_crop(rgb: np.ndarray, size: int = 224,
                    crop: bool = True) -> np.ndarray:
    """Fast host path over an RGB uint8 HWC array (e.g. from cv2.imdecode).
    ``crop=False``: both sides resized to ``size`` and nothing cropped."""
    import cv2

    h, w = rgb.shape[:2]
    nw, nh = _resize_shape(w, h, size) if crop else (size, size)
    interp = cv2.INTER_AREA if (nw < w or nh < h) else cv2.INTER_CUBIC
    rgb = cv2.resize(rgb, (nw, nh), interpolation=interp)
    left = int(round((nw - size) / 2.0))
    top = int(round((nh - size) / 2.0))
    return rgb[top: top + size, left: left + size]


def normalize_host(images_uint8: np.ndarray) -> np.ndarray:
    """(B, S, S, 3) uint8 -> normalized f32 NHWC on the host, in clipx's
    ``normalize_host`` arithmetic: x / 255, minus the mean, over the std,
    in f32 (the training loader's transform)."""
    x = images_uint8.astype(np.float32) / 255.0
    return ((x - np.asarray(CLIP_MEAN, np.float32))
            / np.asarray(CLIP_STD, np.float32)).astype(np.float32)


def normalize_batch(batch_uint8: torch.Tensor,
                    dtype: torch.dtype = torch.float32,
                    mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """(B, S, S, 3) uint8 -> normalized float NHWC on the same device:
    (x - 255 mean) * 1 / (255 std), in f32, then cast to ``dtype``."""
    dev = batch_uint8.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    inv = 1.0 / (torch.tensor(std, dtype=torch.float32,
                              device=dev) * 255.0)
    return ((batch_uint8.float() - mean) * inv).to(dtype)



def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5, on |offsets| >= 0 (the kernel of
    ``jax.image.resize(method="bicubic")``)."""
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    far = ((np.float32(-0.5) * x + np.float32(2.5)) * x
           - np.float32(4)) * x + np.float32(2)
    out = np.where(x >= 1, far, out)
    return np.where(x >= 2, np.float32(0), out).astype(np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 resampling matrix of an antialiased bicubic
    resize, ``jax.image.resize``'s own (``compute_weight_mat`` with zero
    translation): sample points (i + 0.5) in/out - 0.5, the kernel widened
    by in/out when shrinking, each column normalized to sum 1 unless its sum
    is ~0, and columns whose sample point lies outside the input zeroed."""
    inv_scale = np.float32(1) / np.float32(out_size / in_size)
    kernel_scale = max(inv_scale, np.float32(1))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :]
               - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_weights(in_size: int, out_size: int,
                    device: torch.device) -> torch.Tensor:
    """resize_weights on ``device``, transposed to (out, in): built once
    per size pair and device."""
    return torch.from_numpy(resize_weights(in_size, out_size).T.copy()).to(
        device)


def require_square(h: int, w: int) -> None:
    if h != w:
        # a plain resize of a non-square canvas would distort the aspect
        # ratio: shorter-side resize + centre crop is a plain resize only
        # for squares
        raise ValueError(f"device preprocess requires a square canvas, "
                         f"got {h}x{w}")


def device_resize_normalize(batch_uint8: torch.Tensor, size: int = 224,
                            dtype: torch.dtype = torch.float32,
                            mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """(B, S, S, 3) uint8 square canvases -> (B, size, size, 3) normalized
    ``dtype`` on the batch's device: ``jax.image.resize``'s antialiased
    bicubic in f32 (its weight matrix, contracted over H, then W; a side
    already at ``size`` is left as it is, as JAX does), clipped to
    [0, 255], then ``normalize_batch``'s arithmetic. The two contractions
    run in full f32 on CUDA (TF32 off while they run), as the
    search engine's products do."""
    b, h, w, c = batch_uint8.shape
    require_square(h, w)
    dev = batch_uint8.device
    # the constants' host-to-device copies block the host: make them before
    # this batch's work is queued, as normalize_batch does
    mean = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    inv = 1.0 / (torch.tensor(std, dtype=torch.float32,
                              device=dev) * 255.0)
    x = batch_uint8.float()
    if h != size:
        wt = _device_weights(h, size, dev)                     # (size, S)
        with full_f32(dev):
            # H: (size, S) @ (B, S, S*C) -> (B, size, S, C)
            x = torch.matmul(wt, x.reshape(b, h, w * c)).reshape(
                b, size, w, c)
            # W: (B*size*C, S) @ (S, size) -> (B, size, C, size), one GEMM
            # (a 3-D operand would make it B*size tiny 3-row products)
            x = torch.mm(x.transpose(2, 3).reshape(-1, w), wt.T).reshape(
                b, size, c, size)
        x = x.transpose(2, 3).clamp(0.0, 255.0)          # (B, size, size, C)
    return ((x - mean) * inv).to(dtype).contiguous()
