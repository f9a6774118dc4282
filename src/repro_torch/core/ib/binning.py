"""Binning MI estimator — the original IB-papers baseline [Tishby/Shwartz-Ziv].

The paper notes binning is sensitive to bin size (Sec. VI); it is kept here
as the reference estimator the robust ones (KDE/GCMI) are compared against,
exactly mirroring the literature's methodology.
"""
from __future__ import annotations

from collections import Counter
from typing import Tuple

import numpy as np

_LN2 = np.log(2.0)


def _digitize(t: np.ndarray, n_bins: int) -> np.ndarray:
    lo, hi = t.min(), t.max()
    if hi - lo < 1e-12:
        return np.zeros_like(t, dtype=np.int32)
    edges = np.linspace(lo, hi, n_bins + 1)[1:-1]
    return np.digitize(t, edges).astype(np.int32)


def _discrete_entropy(rows: np.ndarray) -> float:
    """Entropy (bits) of the empirical distribution over row patterns."""
    counts = Counter(map(bytes, np.ascontiguousarray(rows)))
    n = rows.shape[0]
    p = np.array(list(counts.values()), dtype=np.float64) / n
    return float(-np.sum(p * np.log(p)) / _LN2)


def bin_mi_tx(t: np.ndarray, n_bins: int = 30) -> float:
    """I(T;X) = H(T_binned) for deterministic T=f(X)."""
    return _discrete_entropy(_digitize(np.asarray(t), n_bins))


def bin_mi_ty(t: np.ndarray, y: np.ndarray, n_classes: int,
              n_bins: int = 30) -> float:
    t = _digitize(np.asarray(t), n_bins)
    h_t = _discrete_entropy(t)
    n = t.shape[0]
    h_cond = 0.0
    for c in range(n_classes):
        idx = y == c
        if idx.sum() < 1:
            continue
        h_cond += (idx.sum() / n) * _discrete_entropy(t[idx])
    return max(h_t - h_cond, 0.0)
