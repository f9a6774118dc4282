"""The port's cell-crossing and fleet channels against the JAX package's.

``repro_torch.core.channel`` is a copy of the reference's pure-numpy module:
for the same seeds and scripts, ``TraceChannel``, ``MobilityChannel``,
``FleetChannel`` (fade, trace and cell-script sources, with mobility) and
``city_grid_cells`` must realize the same capacities, cells, handover
events and latencies bit for bit, whether lanes step together or one at a
time, and the Lumos5G trace resampler must give the same traces.
"""
import numpy as np
import pytest

from repro.core import channel as J
from repro.data.lumos5g import capacity_traces_bps as j_traces
from repro_torch.core import channel as P
from repro_torch.data.lumos5g import capacity_traces_bps as p_traces

CFG = dict(mean_mbps=80.0, std_mbps=30.0, blockage_prob=0.10,
           recovery_prob=0.3, min_mbps=2.0)


def _pair(name, *args, cfg=False, **kw):
    """The same constructor call in both packages."""
    extra = ({"cfg": J.ChannelConfig(**CFG)}, {"cfg": P.ChannelConfig(**CFG)}
             ) if cfg else ({}, {})
    return (getattr(J, name)(*args, **kw, **extra[0]),
            getattr(P, name)(*args, **kw, **extra[1]))


@pytest.mark.parametrize("cycle", [False, True])
def test_trace_channel_matches(cycle):
    rng = np.random.default_rng(0)
    caps = rng.uniform(1e5, 1e8, size=13)
    j, p = _pair("TraceChannel", caps, cycle=cycle)
    got = [p.step() for _ in range(40)]
    assert got == [j.step() for _ in range(40)]
    assert p.t == j.t


@pytest.mark.parametrize("detach", [0.05, 1.0])
@pytest.mark.parametrize("cycle", [False, True])
def test_mobility_channel_matches(detach, cycle):
    """Capacities, crossings, pending events, detach state and
    crossing -> re-home latencies, with the serving side re-homing at some
    ticks and not at others."""
    cells = [0] * 5 + [1] * 7 + [2] * 3 + [0] * 4
    caps = [4e8, 2e8, 1e8]
    j, p = _pair("MobilityChannel", cells, caps, detach_factor=detach,
                 cycle=cycle)
    j.serving_cell = p.serving_cell = 0
    for t in range(45):
        assert p.current_cell == j.current_cell
        assert p.step() == j.step(), t
        assert (p.pending_handover, p.detached, p.last_cell) == \
            (j.pending_handover, j.detached, j.last_cell), t
        if t in (8, 17, 30):
            p.ack_handover(p.last_cell)
            j.ack_handover(j.last_cell)
    assert p.handover_ticks == j.handover_ticks and p.handover_ticks
    assert p.handover_latencies == j.handover_latencies
    assert P.is_mobile(p) and not P.is_mobile(P.TraceChannel([1.0]))


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fade_fleet_matches(seed):
    """Fade mode: the vectorized fleet and the port's scalar fleet equal the
    reference's fleet, stepped together and per lane in a ragged order."""
    n, T = 9, 48
    j, p = _pair("FleetChannel", n, seed=seed, cfg=True)
    got = np.stack([p.step_all() for _ in range(T)])
    want = np.stack([j.step_all() for _ in range(T)])
    assert np.array_equal(got, want)
    scalars = P.channel_fleet(n, P.ChannelConfig(**CFG), seed=seed)
    assert np.array_equal(
        np.stack([[c.step() for c in scalars] for _ in range(T)]), want)
    j, p = _pair("FleetChannel", n, seed=seed, cfg=True)
    rng = np.random.default_rng(seed)
    for _ in range(3 * n * 8):
        i = int(rng.integers(n))
        assert p.lane(i).peek() == j.lane(i).peek()
        assert p.lane(i).step() == j.lane(i).step()
    assert np.array_equal(p.peek_all(), j.peek_all())


@pytest.mark.parametrize("source", ["traces", "cell_caps"])
def test_mobile_fleet_matches(source):
    """A fleet with a cell script (``city_grid_cells``) over Lumos5G-shaped
    traces or per-cell capacities: capacities, events and latencies."""
    n, T, n_cells = 6, 40, 3
    cells_j = J.city_grid_cells(n, T, n_cells, seed=5, dwell_ticks=5)
    cells_p = P.city_grid_cells(n, T, n_cells, seed=5, dwell_ticks=5)
    assert np.array_equal(cells_j, cells_p)
    kw = ({"traces_bps": p_traces(n, T, seed=3)} if source == "traces"
          else {"cell_caps_bps": [4e8, 2e8, 1e8]})
    j, p = _pair("FleetChannel", n, cells=cells_p, detach_factor=0.1, **kw)
    for i in range(n):
        j.lane(i).serving_cell = p.lane(i).serving_cell = 0
    for t in range(T + 5):
        assert np.array_equal(p.peek_all(), j.peek_all()), t
        assert np.array_equal(p.step_all(), j.step_all()), t
        for i in range(n):
            lp, lj = p.lane(i), j.lane(i)
            assert (lp.pending_handover, lp.detached, lp.current_cell,
                    lp.last_cell) == (lj.pending_handover, lj.detached,
                                      lj.current_cell, lj.last_cell)
            if t in (9, 23):
                lp.ack_handover(lp.last_cell)
                lj.ack_handover(lj.last_cell)
    for i in range(n):
        assert p.lane(i).handover_ticks == j.lane(i).handover_ticks
        assert p.lane(i).handover_latencies == j.lane(i).handover_latencies
    assert P.is_mobile(p.lane(0))


@pytest.mark.parametrize("n_cells,dwell", [(1, 4), (2, 3), (5, 64)])
def test_city_grid_cells_match(n_cells, dwell):
    for seed in (0, 1, 9):
        assert np.array_equal(
            P.city_grid_cells(17, 50, n_cells, seed=seed, dwell_ticks=dwell),
            J.city_grid_cells(17, 50, n_cells, seed=seed, dwell_ticks=dwell))


def test_capacity_traces_match():
    for n, T, seed in ((4, 30, 0), (64, 512, 2)):
        assert np.array_equal(p_traces(n, T, seed=seed),
                              j_traces(n, T, seed=seed))


def test_constructor_validation_matches():
    """Both packages refuse the same malformed fleets and scripts."""
    bad = [lambda m: m.FleetChannel(0),
           lambda m: m.FleetChannel(2, traces_bps=np.ones((2, 3)),
                                    cell_caps_bps=[1.0],
                                    cells=np.zeros((2, 3), int)),
           lambda m: m.FleetChannel(2, cell_caps_bps=[1.0]),
           lambda m: m.FleetChannel(2, traces_bps=np.ones((3, 3))),
           lambda m: m.FleetChannel(2, cells=np.ones((2, 3), int),
                                    cell_caps_bps=[1.0]),
           lambda m: m.MobilityChannel([], [1.0]),
           lambda m: m.MobilityChannel([0, 2], [1.0, 2.0]),
           lambda m: m.TraceChannel([]),
           lambda m: m.city_grid_cells(2, 3, 0)]
    for make in bad:
        for mod in (J, P):
            with pytest.raises(ValueError):
                make(mod)
