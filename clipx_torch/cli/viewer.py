"""cv2 result viewer (reference:query-index.py:122-154) with headless
fallback.

Keeps the reference's UX: each result image is shown in a window titled
'Image'; optional Lanczos4 downscale to a max resolution preserving
aspect; optional window alignment at (0, 0); space advances to the next
image, ``q`` stops viewing the current result list. When no display is
available (no $DISPLAY / cv2 GUI error / $CLIPX_NO_VIEWER set) results
are print-only and never block — the degradation path SURVEY.md section
2b D5 calls for.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple


def fit_resolution(w: int, h: int, max_res: Tuple[int, int]):
    """The reference's scale-to-fit arithmetic, reference:query-index.py:126-139
    — sequential width-then-height clamping with float accumulation and
    the final ``int(x + 0.5)`` rounding. Returns (new_w, new_h, resized)."""
    need_resize = False
    if w > max_res[0]:
        factor = float(max_res[0]) / float(w)
        w = max_res[0]
        h *= factor
        need_resize = True
    if h > max_res[1]:
        factor = float(max_res[1]) / float(h)
        h = max_res[1]
        w *= factor
        need_resize = True
    return int(w + 0.5), int(h + 0.5), need_resize


class ImageViewer:
    """show(path) -> False to keep going, True when the user quit the
    result list (the reference's ``do_break``)."""

    def __init__(self):
        self.align_window = False
        self.max_res: Optional[Tuple[int, int]] = None
        self._headless = bool(os.environ.get("CLIPX_NO_VIEWER")) or \
            not os.environ.get("DISPLAY")

    def show(self, path: str) -> bool:
        if self._headless:
            return False
        try:
            return self._show_cv2(path)
        except Exception:
            # cv2 GUI unavailable after all — degrade permanently
            self._headless = True
            return False

    def _show_cv2(self, path: str) -> bool:
        import cv2

        image = cv2.imread(path, cv2.IMREAD_COLOR)
        if image is None or image.shape[0] < 2:  # reference:query-index.py:123
            return False
        h, w, _ = image.shape
        if self.max_res is not None:
            new_w, new_h, need_resize = fit_resolution(w, h, self.max_res)
            if need_resize:
                image = cv2.resize(image, (new_w, new_h),
                                   interpolation=cv2.INTER_LANCZOS4)
        cv2.imshow("Image", image)
        if self.align_window:
            cv2.moveWindow("Image", 0, 0)
        while True:  # reference:query-index.py:143-151
            key = cv2.waitKey(0) & 0xFF
            if key == ord(" "):
                return False
            if key == ord("q"):
                return True

    def close(self) -> None:
        if self._headless:
            return
        try:
            import cv2

            cv2.destroyAllWindows()  # reference:query-index.py:154
        except Exception:
            pass
