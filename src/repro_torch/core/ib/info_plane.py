"""Information-plane and temporal-information analysis (paper Figs. 1, 7-9).

Estimator assignment follows Sec. VI: GCMI for I(X;H) (robust to
multidimensional variables), Kolchinsky KDE for I(H;Y), and the GCMI
conditional-MI extension for the temporal-redundancy analysis that justifies
truncating H^(1) to its last few temporal states (paper Eq. 3).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.ib import gcmi, kde

# PCA cap applied before covariance-based estimation; the paper's point that
# "estimating the MI can be challenging due to the large hidden temporal
# states" is exactly this — we reduce dimensions the same way it reduces
# temporal states (Eq. 3).
_MAX_DIM = 32


def _reduce(x: np.ndarray, max_dim: int = _MAX_DIM) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    if x.shape[1] <= max_dim:
        return x
    xc = x - x.mean(0)
    # SVD-based PCA (deterministic)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    return xc @ vt[:max_dim].T


def layer_point(h: np.ndarray, x: np.ndarray, y: np.ndarray,
                n_classes: int, noise_var: float = 0.1) -> Dict[str, float]:
    """One information-plane point for a layer activation h.

    h: [N, ...] flattened per sample; x: [N, ...]; y: [N] ints.
    """
    hr, xr = _reduce(h), _reduce(x)
    return {
        "I_XH": gcmi.gcmi_cc(xr, hr),
        "I_HY": kde.mi_ty(hr, y, n_classes, noise_var),
    }


def information_plane(acts_by_epoch: Sequence[Dict[str, np.ndarray]],
                      x: np.ndarray, y: np.ndarray, layer_names: List[str],
                      n_classes: int) -> Dict[str, List[Dict[str, float]]]:
    """Per-epoch, per-layer (I(X;H), I(H;Y)) trajectories (Figs. 1/9)."""
    out: Dict[str, List[Dict[str, float]]] = {name: [] for name in layer_names}
    for acts in acts_by_epoch:
        for name in layer_names:
            out[name].append(layer_point(acts[name], x, y, n_classes))
    return out


def temporal_curves(acts_by_epoch: Sequence[np.ndarray], x: np.ndarray,
                    y_tau: np.ndarray, n_classes: int) -> Dict[str, np.ndarray]:
    """The 3-D information curves (Figs. 7-8).

    acts_by_epoch: sequence over epochs of H^{(1)} activations [N, T, cells].
    x: [N, T, D] inputs; y_tau: [N] the label at the probe timestep tau.
    Returns I_HtY [epochs, T] = I(H_t; y_tau) and
            I_XH  [epochs, T] = I(x_1..x_t ; H_1..H_t).
    """
    E = len(acts_by_epoch)
    T = acts_by_epoch[0].shape[1]
    i_hty = np.zeros((E, T))
    i_xh = np.zeros((E, T))
    for e, h in enumerate(acts_by_epoch):
        for t in range(T):
            i_hty[e, t] = kde.mi_ty(_reduce(h[:, t]), y_tau, n_classes)
            i_xh[e, t] = gcmi.gcmi_cc(_reduce(x[:, :t + 1]),
                                      _reduce(h[:, :t + 1]))
    return {"I_HtY": i_hty, "I_XH": i_xh}


def temporal_redundancy(h1: np.ndarray, x: np.ndarray,
                        max_condition: int = 3) -> List[float]:
    """Conditional-MI redundancy ladder (paper Sec. VI):
    [ I(X; H_T | H_{T-1}), I(X; H_T | H_{T-1}, H_{T-2}), ... ].

    h1: [N, T, cells]; x: [N, T, D].
    """
    T = h1.shape[1]
    xf = _reduce(x)
    hT = _reduce(h1[:, T - 1])
    out = []
    for k in range(1, max_condition + 1):
        cond = _reduce(h1[:, T - 1 - k:T - 1])
        out.append(gcmi.gccmi_ccc(xf, hT, cond))
    return out


def compression_onset(i_xh_by_epoch: np.ndarray) -> int:
    """Epoch index where I(X;H) peaks (fitting->compression transition)."""
    return int(np.argmax(np.asarray(i_xh_by_epoch)))
