"""The port's Lumos5G twin against the JAX package's: the same numpy
generator, so every array must be equal, element for element, for each
seed."""
import numpy as np
import pytest

from repro.data import lumos5g as JD
from repro_torch.data import lumos5g as TD


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_split_and_batches_equal_reference(seed):
    cj = JD.Lumos5GConfig(n_samples=700, seq_len=20, seed=seed)
    ct = TD.Lumos5GConfig(n_samples=700, seq_len=20, seed=seed)
    dj, dt = JD.generate(cj), TD.generate(ct)
    _equal(dj, dt)
    for pj, pt in zip(JD.train_test_split(dj, cj),
                      TD.train_test_split(dt, ct)):
        _equal(pj, pt)
    trj, _ = JD.train_test_split(dj, cj)
    trt, _ = TD.train_test_split(dt, ct)
    itj = JD.batch_iterator(trj, 32, seed)
    itt = TD.batch_iterator(trt, 32, seed)
    batches = [next(itj) for _ in range(4)]
    for bj in batches:
        _equal(bj, next(itt))
    # the port's stacked form holds the same batches in order
    st = TD.stacked_batches(trt, 32, 4, seed)
    _equal({k: np.stack([b[k] for b in batches]) for k in ("x", "y")}, st)


@pytest.mark.parametrize("seed", [0, 3])
def test_series_and_capacity_traces_equal_reference(seed):
    np.testing.assert_array_equal(JD.throughput_series_mbps(300, seed),
                                  TD.throughput_series_mbps(300, seed))
    kw = dict(tick_seconds=0.1, seed=seed, stagger_seconds=30.0)
    np.testing.assert_array_equal(JD.capacity_traces_bps(6, 90, **kw),
                                  TD.capacity_traces_bps(6, 90, **kw))
    with pytest.raises(ValueError):
        TD.capacity_traces_bps(0, 10)
