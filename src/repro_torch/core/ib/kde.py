"""Kolchinsky–Tracey pairwise-distance KDE bound on mixture entropy
[Entropy 2017; used by Saxe et al. 2019 and by the paper for I(H;Y)].

Model: the layer activation T is taken as T + N(0, noise_var I) (the standard
trick that makes MI finite for deterministic networks). The entropy of the
resulting Gaussian mixture is bounded with the pairwise KL (upper) /
Bhattacharyya (lower) distance bounds; MI follows as

  I(T;X) = H(T) - H(T|X) = H_mix(T) - d/2 log(2 pi e sigma^2)
  I(T;Y) = H_mix(T) - sum_y p(y) H_mix(T | Y=y)

Returned in BITS.
"""
from __future__ import annotations

import numpy as np

_LN2 = np.log(2.0)


def _pairwise_sq_dists(t: np.ndarray, max_n: int = 2048,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    if t.shape[0] > max_n:
        rng = rng or np.random.default_rng(0)
        t = t[rng.choice(t.shape[0], max_n, replace=False)]
    sq = np.sum(t * t, axis=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (t @ t.T)
    return np.maximum(d2, 0.0)


def mixture_entropy_upper(t: np.ndarray, noise_var: float,
                          max_n: int = 2048) -> float:
    """KL-distance upper bound on H(T + noise), bits. t: [N, d]."""
    t = np.asarray(t, dtype=np.float64)
    n, d = t.shape
    d2 = _pairwise_sq_dists(t, max_n)
    n_eff = d2.shape[0]
    # -mean_i log mean_j exp(-KL_ij), KL_ij = ||ti-tj||^2 / (2 sigma^2)
    logits = -d2 / (2.0 * noise_var)
    lse = np.logaddexp.reduce(logits, axis=1) - np.log(n_eff)
    h_pairwise = -np.mean(lse)
    h_component = 0.5 * d * np.log(2 * np.pi * np.e * noise_var)
    return (h_pairwise + h_component) / _LN2


def mi_tx(t: np.ndarray, noise_var: float = 0.1, max_n: int = 2048) -> float:
    """I(T; X) for deterministic T = f(X) under additive Gaussian noise."""
    t = np.asarray(t, dtype=np.float64)
    d = t.shape[1]
    h_t = mixture_entropy_upper(t, noise_var, max_n)
    h_t_given_x = 0.5 * d * np.log(2 * np.pi * np.e * noise_var) / _LN2
    return max(h_t - h_t_given_x, 0.0)


def mi_ty(t: np.ndarray, y: np.ndarray, n_classes: int,
          noise_var: float = 0.1, max_n: int = 2048) -> float:
    """I(T; Y) with discrete labels y [N]."""
    t = np.asarray(t, dtype=np.float64)
    n = t.shape[0]
    h_t = mixture_entropy_upper(t, noise_var, max_n)
    h_cond = 0.0
    for c in range(n_classes):
        idx = y == c
        k = int(idx.sum())
        if k < 2:
            continue
        h_cond += (k / n) * mixture_entropy_upper(t[idx], noise_var, max_n)
    return max(h_t - h_cond, 0.0)
