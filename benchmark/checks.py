"""The numbers that decide ``correct``, each a worst case over the
window's answers. A number that cannot be read (an answer of the wrong
shape, a missing row) reads ``FAIL``, finite so the result stays JSON."""

from __future__ import annotations

import numpy as np

FAIL = 1e30


def embedding_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest L2 distance between a row of ``got`` and the same row of
    ``ref`` (both L2-normalised)."""
    if got.shape != ref.shape or not np.isfinite(got).all():
        return FAIL
    return float(np.sqrt(((got.astype(np.float64) - ref) ** 2).sum(1)).max())


def ranking_gap(d_got: np.ndarray, i_got: np.ndarray, d_ref: np.ndarray,
                s_got: np.ndarray, rows: int) -> float:
    """For top-k answers: the largest of, at any rank, the distance between
    the returned score and the reference's k-th best score at that rank,
    and between the returned score and the reference's score of the
    returned row. Ties and near-ties in the reference cost nothing; a
    missed row, a wrong score or a row returned twice does."""
    if (d_got.shape != d_ref.shape or i_got.shape != d_ref.shape
            or not np.isfinite(d_got).all() or (i_got < 0).any()
            or (i_got >= rows).any()):
        return FAIL
    if any(len(set(r.tolist())) != len(r) for r in i_got):
        return FAIL
    return float(max(np.abs(d_got - d_ref).max(),
                     np.abs(d_got - s_got).max()))
