"""The port's information-bottleneck estimators against the JAX package's
(both numpy and scipy only): the same arrays, drawn with numpy from a seed,
must give the same estimates, float for float."""
import numpy as np
import pytest

from repro.core.ib import binning as JB
from repro.core.ib import gcmi as JG
from repro.core.ib import info_plane as JI
from repro.core.ib import kde as JK
from repro_torch.core.ib import binning as TB
from repro_torch.core.ib import gcmi as TG
from repro_torch.core.ib import info_plane as TI
from repro_torch.core.ib import kde as TK


def _arrays():
    rng = np.random.default_rng(7)
    n = 600
    x = rng.normal(size=(n, 4))
    h = np.tanh(x @ rng.normal(size=(4, 6)) + 0.3 * rng.normal(size=(n, 6)))
    y = (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0.5)
    z = h[:, :2] + 0.1 * rng.normal(size=(n, 2))
    return x, h, y, z


# (name, call on (pkg modules, arrays)) — each estimator of the reference
CASES = {
    "gcmi.copula_normalize": lambda m, a: m["g"].copula_normalize(a[1]),
    "gcmi.mi_gg": lambda m, a: m["g"].mi_gg(a[0], a[1]),
    "gcmi.mi_gg_no_bias": lambda m, a: m["g"].mi_gg(a[0], a[1],
                                                   bias_correct=False),
    "gcmi.gcmi_cc": lambda m, a: m["g"].gcmi_cc(a[0], a[1]),
    "gcmi.cmi_ggg": lambda m, a: m["g"].cmi_ggg(a[0], a[1], a[3]),
    "gcmi.gccmi_ccc": lambda m, a: m["g"].gccmi_ccc(a[0], a[1], a[3]),
    "gcmi.gcmi_model_cd": lambda m, a: m["g"].gcmi_model_cd(a[1], a[2], 3),
    "kde.mixture_entropy_upper": lambda m, a: m["k"].mixture_entropy_upper(
        a[1], 0.1, max_n=256),
    "kde.mi_tx": lambda m, a: m["k"].mi_tx(a[1], 0.1),
    "kde.mi_tx_subsampled": lambda m, a: m["k"].mi_tx(a[1], 0.1, max_n=200),
    "kde.mi_ty": lambda m, a: m["k"].mi_ty(a[1], a[2], 3),
    "binning.bin_mi_tx": lambda m, a: m["b"].bin_mi_tx(a[1], 12),
    "binning.bin_mi_ty": lambda m, a: m["b"].bin_mi_ty(a[1], a[2], 3, 12),
    "info_plane.layer_point": lambda m, a: m["i"].layer_point(
        a[1], a[0], a[2], 3),
    "info_plane.layer_point_pca": lambda m, a: m["i"].layer_point(
        np.concatenate([a[1]] * 7, axis=1), a[0], a[2], 3),
    "info_plane.compression_onset": lambda m, a: m["i"].compression_onset(
        a[1][:, 0]),
}

J = {"g": JG, "k": JK, "b": JB, "i": JI}
T = {"g": TG, "k": TK, "b": TB, "i": TI}


@pytest.mark.parametrize("name", sorted(CASES))
def test_estimator_equals_reference(name):
    a = _arrays()
    want, got = CASES[name](J, a), CASES[name](T, a)
    if isinstance(want, dict):
        assert want == got
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.all(np.isfinite(np.asarray(list(want.values()) if
                                         isinstance(want, dict) else want)))


def test_temporal_curves_and_redundancy_equal_reference():
    rng = np.random.default_rng(11)
    n, t, d, cells = 300, 5, 3, 4
    x = rng.normal(size=(n, t, d))
    acts = [np.tanh(np.cumsum(x @ rng.normal(size=(d, cells)), axis=1) * s)
            for s in (0.5, 1.0)]
    y_tau = (x[:, 2, 0] > 0).astype(np.int32)
    cj = JI.temporal_curves(acts, x, y_tau, 2)
    ct = TI.temporal_curves(acts, x, y_tau, 2)
    for k in ("I_HtY", "I_XH"):
        np.testing.assert_array_equal(ct[k], cj[k])
    assert (TI.temporal_redundancy(acts[1], x, max_condition=3)
            == JI.temporal_redundancy(acts[1], x, max_condition=3))
    plane_j = JI.information_plane([{"H": acts[0][:, -1]}], x[:, 0], y_tau,
                                   ["H"], 2)
    plane_t = TI.information_plane([{"H": acts[0][:, -1]}], x[:, 0], y_tau,
                                   ["H"], 2)
    assert plane_j == plane_t
