"""Gaussian-copula mutual information (GCMI) estimator [Ince et al. 2017],
the paper's choice for I(X;H) in sequential models (Sec. VI): robust to
multidimensional variables and marginal distributions, and extends to
conditional MI — which the paper uses to quantify temporal-state redundancy,
e.g. I(x_1..x_T ; H_T | H_{T-1}, H_{T-2}).

All quantities are returned in BITS.
"""
from __future__ import annotations

import numpy as np
from scipy.special import ndtri, psi

_LN2 = np.log(2.0)


def copula_normalize(x: np.ndarray) -> np.ndarray:
    """Rank -> standard-normal transform per column. x: [N, d]."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    ranks = np.argsort(np.argsort(x, axis=0), axis=0).astype(np.float64)
    return ndtri((ranks + 1.0) / (n + 1.0))


def _ent_g(x: np.ndarray, *, bias_correct: bool = True) -> float:
    """Differential entropy (bits) of multivariate Gaussian fit to x [N,d]."""
    n, d = x.shape
    c = np.cov(x, rowvar=False).reshape(d, d)
    # regularize for near-singular covariances
    c = c + 1e-10 * np.eye(d)
    sign, logdet = np.linalg.slogdet(c)
    h = 0.5 * (d * np.log(2 * np.pi * np.e) + logdet)
    if bias_correct and n > d + 1:
        # Ince et al. 2017: E[log det(sample cov)] differs from
        # log det(true cov) by sum_i psi((n-i)/2) - d*log((n-1)/2).
        h += 0.5 * (sum(psi((n - i) / 2.0) for i in range(1, d + 1))
                    - d * np.log((n - 1) / 2.0))
    return h / _LN2


def mi_gg(x: np.ndarray, y: np.ndarray, *, bias_correct: bool = True) -> float:
    """Gaussian MI I(X;Y) in bits. x: [N,dx], y: [N,dy] (already Gaussian)."""
    x = np.atleast_2d(x.T).T
    y = np.atleast_2d(y.T).T
    xy = np.concatenate([x, y], axis=1)
    return max(_ent_g(x, bias_correct=bias_correct)
               + _ent_g(y, bias_correct=bias_correct)
               - _ent_g(xy, bias_correct=bias_correct), 0.0)


def gcmi_cc(x: np.ndarray, y: np.ndarray) -> float:
    """Copula MI between continuous multivariates (lower bound on true MI)."""
    return mi_gg(copula_normalize(x), copula_normalize(y))


def cmi_ggg(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> float:
    """Gaussian conditional MI I(X;Y|Z) in bits."""
    x, y, z = (np.atleast_2d(a.T).T for a in (x, y, z))
    xz = np.concatenate([x, z], axis=1)
    yz = np.concatenate([y, z], axis=1)
    xyz = np.concatenate([x, y, z], axis=1)
    v = (_ent_g(xz) + _ent_g(yz) - _ent_g(z) - _ent_g(xyz))
    return max(v, 0.0)


def gccmi_ccc(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> float:
    """Copula conditional MI (continuous x, y, z)."""
    return cmi_ggg(copula_normalize(x), copula_normalize(y),
                   copula_normalize(z))


def gcmi_model_cd(x: np.ndarray, y: np.ndarray, n_classes: int) -> float:
    """I(X;Y) for continuous X, discrete Y: copula-normalize X then
    class-conditional Gaussian mixture formula. y: [N] ints."""
    cx = copula_normalize(x)
    n, d = cx.shape
    h_x = _ent_g(cx)
    h_cond = 0.0
    for c in range(n_classes):
        idx = y == c
        k = int(idx.sum())
        if k < d + 2:     # not enough samples to fit a class covariance
            continue
        h_cond += (k / n) * _ent_g(cx[idx])
    return max(h_x - h_cond, 0.0)
