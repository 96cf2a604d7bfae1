"""Streaming host-side decode pipeline feeding the device encoder.

The port's own copy of ``clipx/data/pipeline.py``, over the port's
preprocess functions.

Replaces the reference's per-image synchronous ``Image.open`` ->
``transform`` -> forward loop (reference:build-index.py:45-51, hot loop #1
in SURVEY.md section 3.1) with a bounded-prefetch thread pool: JPEG/PNG
decode and resize run in cv2/PIL C code (GIL released) while the GPU
encodes the previous batch.

Per-file failure attribution is preserved: a decode error yields a
``DecodeItem`` with ``error`` set, which the indexer records in skip_db
exactly like the reference's ``#`` path (reference:build-index.py:55-61).
Decoding on the host *before* batching is what makes batched encode
compatible with per-file skip semantics (SURVEY.md section 5, failure
detection).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Iterable, Iterator, List, Optional

import numpy as np

from clipx_torch.ops.preprocess import cv2_resize_crop, pil_resize_crop

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")


@dataclasses.dataclass
class DecodeItem:
    path: str
    array: Optional[np.ndarray]  # (size, size, 3) uint8, or None on error
    error: Optional[str] = None


def scan_folder(base_path: str) -> List[str]:
    """The reference's folder scan (reference:build-index.py:30-34):
    non-recursive listdir, paths formed by *string concatenation* (no
    os.path.join — callers must pass dirs with a trailing slash, a
    documented quirk), case-insensitive .jpg/.jpeg/.png filter."""
    out = []
    for fn in os.listdir(base_path):
        tfn = base_path + fn
        ext = os.path.splitext(fn)[1]
        if ext.lower() not in IMAGE_EXTENSIONS:
            continue
        out.append(tfn)
    return out


def _reduced_jpeg_flag(path: str, size: int):
    """cv2 imdecode flag for DCT-domain reduced JPEG decode: libjpeg can
    decode directly at 1/2, 1/4, or 1/8 resolution for a large fraction
    of the decode cost. Picks the deepest reduction whose shorter side
    still covers the target (so the resize stays a downscale); non-JPEG
    or unparsable headers fall back to a full decode. Reads the header
    lazily from the file (a handful of KB from the page cache), not a
    copy of the whole compressed buffer."""
    import cv2
    from PIL import Image

    try:
        with Image.open(path) as im:
            if im.format != "JPEG":
                return cv2.IMREAD_COLOR
            w, h = im.size
    except Exception:  # noqa: BLE001 — header peek is best-effort
        return cv2.IMREAD_COLOR
    short = min(w, h)
    for div, flag in ((8, cv2.IMREAD_REDUCED_COLOR_8),
                      (4, cv2.IMREAD_REDUCED_COLOR_4),
                      (2, cv2.IMREAD_REDUCED_COLOR_2)):
        if short // div >= size:
            return flag
    return cv2.IMREAD_COLOR


def decode_bytes_rgb(data: np.ndarray, size: int, flag=None,
                     crop: bool = True) -> np.ndarray:
    """Compressed image bytes -> (size, size, 3) RGB uint8 through the
    cv2 decode path (imdecode, BGR->RGB, cv2_resize_crop): the indexer's
    default preprocessing (``crop=False``: resized, not cropped)."""
    import cv2

    img = cv2.imdecode(data, cv2.IMREAD_COLOR if flag is None else flag)
    if img is None:
        raise ValueError("cv2 could not decode")
    rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return cv2_resize_crop(rgb, size, crop)


def _decode_one(path: str, size: int, backend: str,
                fast: bool = False, crop: bool = True) -> DecodeItem:
    try:
        if backend == "cv2":
            import cv2

            flag = (_reduced_jpeg_flag(path, size) if fast
                    else cv2.IMREAD_COLOR)
            data = np.fromfile(path, dtype=np.uint8)
            return DecodeItem(path, decode_bytes_rgb(data, size, flag, crop))
        else:
            from PIL import Image

            with Image.open(path) as img:
                if fast:
                    # JPEG draft mode: same DCT-domain shortcut as the
                    # cv2 path (no-op for other formats)
                    img.draft("RGB", (size, size))
                return DecodeItem(path, pil_resize_crop(img, size, crop))
    except Exception as exc:  # noqa: BLE001 — per-file tolerance by design
        return DecodeItem(path, None, error=f"{type(exc).__name__}: {exc}")


def iter_decoded(paths: Iterable[str], size: int = 224, *,
                 backend: str = "cv2", workers: int = 4,
                 prefetch: int = 64, fast: bool = False,
                 crop: bool = True) -> Iterator[DecodeItem]:
    """Decode ``paths`` concurrently with at most ``prefetch`` decodes in
    flight. By default results yield as they complete (bounded
    out-of-order window): one pathological file never stalls finished
    decodes behind it — the indexer doesn't care about arrival order
    because ids are assigned in phase 2 from sorted LMDB keys, so order
    only affects progress dots. ``fast`` enables
    reduced JPEG decode (measured ~3x decode throughput on full-size
    photos; pixels differ slightly from a full decode, so it's opt-in).
    ``crop=False`` resizes to ``size`` x ``size`` with no centre crop (the
    model's ``center_crop``: SigLIP's transform)."""
    paths = iter(paths)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = set()
        for path in paths:
            pending.add(pool.submit(_decode_one, path, size, backend, fast,
                                    crop))
            if len(pending) >= prefetch:
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    yield fut.result()
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                yield fut.result()


def batched(items: Iterable[DecodeItem], batch_size: int
            ) -> Iterator[List[DecodeItem]]:
    """Group decoded items into encode batches; failed decodes pass
    through as singleton metadata (they never enter a batch)."""
    batch: List[DecodeItem] = []
    for item in items:
        if item.array is None:
            yield [item]
            continue
        batch.append(item)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
