"""The port's autoscaler, SLO admission gate and fleet load generator
against the JAX package's.

``Autoscaler``, ``SLOAdmission``, ``arrival_ticks`` and ``fleet_requests``
are pure functions of their inputs (copies of the reference's numpy code):
on the same observation sequences they must return the same decisions,
events and records, and on the same fleet the same requests. Also the
port's cluster applies the decisions as the reference does: scale-up
revives a drained replica before adding one, scale-down drains live
sessions through migration without stranding one, and a retired replica
gets no new work.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.channel import FleetChannel as JFleet
from repro.serving import controller as JC
from repro.serving import fleet as JF
from repro_torch.configs import get_reduced
from repro_torch.core import split as SP
from repro_torch.core.channel import FleetChannel as PFleet
from repro_torch.core.channel import MobilityChannel
from repro_torch.serving import EdgeCluster, Request
from repro_torch.serving import controller as PC
from repro_torch.serving import fleet as PF


def _observations(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    occ = np.clip(np.cumsum(rng.normal(0, 0.15, n)) % 1.3, 0, 1)
    qps = np.where(rng.random(n) < 0.3, rng.exponential(1.0, n), 0.0)
    miss = np.where(rng.random(n) < 0.2, rng.uniform(0, 0.2, n), 0.0)
    return occ, qps, miss


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("cfg", [
    {}, {"sustain_ticks": 1, "cooldown_ticks": 0, "max_replicas": 3},
    {"min_replicas": 2, "high_occupancy": 0.6, "low_occupancy": 0.5,
     "ema": 0.0}], ids=["default", "eager", "narrow"])
def test_autoscaler_decisions_match(seed, cfg):
    """The same observation sequence, with the replica count following
    the decisions, gives the same decisions, smoothed occupancy and
    events."""
    occ, qps, miss = _observations(seed)
    j = JC.Autoscaler(JC.AutoscalerConfig(**cfg))
    p = PC.Autoscaler(PC.AutoscalerConfig(**cfg))
    n_j = n_p = max(cfg.get("min_replicas", 1), 1)
    for o, q, m in zip(occ, qps, miss):
        dj = j.observe(n_replicas=n_j, occupancy=float(o),
                       queue_per_slot=float(q), miss_rate=float(m))
        dp = p.observe(n_replicas=n_p, occupancy=float(o),
                       queue_per_slot=float(q), miss_rate=float(m))
        assert dp == dj and p.occ_ema == j.occ_ema
        n_j, n_p = n_j + dj, n_p + dp
    assert p.events == j.events and p.events


def test_autoscaler_validation_matches():
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2}):
        for mod in (JC, PC):
            with pytest.raises(ValueError):
                mod.Autoscaler(mod.AutoscalerConfig(**kw))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("min_payload", [None, 64, 4096])
def test_slo_admission_decisions_match(seed, min_payload):
    """Verdicts, per-reason counters and the structured event records."""
    cfg = dict(latency_budget_s=0.01, hopeless_factor=2.0,
               park_queue_per_slot=1.5, park_max_ticks=16)
    j = JF.SLOAdmission(min_payload, JF.SLOAdmissionConfig(**cfg),
                        events_capacity=64)
    p = PF.SLOAdmission(min_payload, PF.SLOAdmissionConfig(**cfg),
                        events_capacity=64)
    rng = np.random.default_rng(seed)
    for rid in range(200):
        kw = dict(slo_ticks=(None if rng.random() < 0.2
                             else int(rng.integers(5, 120))),
                  predicted_wait_ticks=int(rng.integers(0, 80)),
                  service_ticks=int(rng.integers(1, 40)),
                  capacity_bps=(None if rng.random() < 0.3
                                else float(rng.uniform(1e3, 1e7))),
                  queue_per_slot=float(rng.uniform(0, 3)), rid=rid)
        assert p.decide(**kw) == j.decide(**kw), kw
    assert p.stats() == j.stats()
    assert list(p.events) == list(j.events) and len(p.events) == 64


@pytest.mark.parametrize("arrival", ["poisson", "heavy-tail", "burst"])
def test_fleet_requests_match(arrival):
    """Arrival ticks, prompts, budgets and SLOs of the load generator, each
    request riding its own lane of the fleet."""
    n = 40
    traces = np.abs(np.random.default_rng(1).normal(1e7, 3e6, (n, 32)))
    kw = dict(arrival=arrival, mean_interarrival_ticks=1.7,
              prompt_len=6, prompt_len_jitter=2, max_new_tokens=5,
              vocab=500, slo_ticks=40, seed=3)
    jr = JF.fleet_requests(JFleet(n, traces_bps=traces, cycle=True),
                           JF.FleetLoadConfig(**kw))
    pf = PFleet(n, traces_bps=traces, cycle=True)
    pr = PF.fleet_requests(pf, PF.FleetLoadConfig(**kw))
    assert [r.rid for r in pr] == [r.rid for r in jr]
    for a, b in zip(pr, jr):
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.arrival_tick, a.max_new_tokens, a.slo_ticks) == \
            (b.arrival_tick, b.max_new_tokens, b.slo_ticks)
        assert a.channel is pf.lane(a.rid)
    assert np.array_equal(PF.arrival_ticks(n, PF.FleetLoadConfig(**kw)),
                          JF.arrival_ticks(n, JF.FleetLoadConfig(**kw)))
    with pytest.raises(ValueError):
        PF.arrival_ticks(n, dataclasses.replace(PF.FleetLoadConfig(**kw),
                                                arrival="flat"))


# ---------------------------------------------------------------------------
# the cluster applies the decisions (port only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    cfg = get_reduced("qwen2.5-3b")
    return cfg, SP.init_split_params(torch.Generator().manual_seed(0), cfg)


def _prompt(cfg, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=4).astype(np.int32)


def test_scale_down_drains_and_scale_up_revives(model):
    """Retiring a busy replica re-routes its queue, drains its live
    sessions to the other replica by migration (nothing stranded, every
    request finishes), gives it no new work, and a later scale-up revives
    the drained replica instead of adding one."""
    cfg, params = model
    cluster = EdgeCluster(params, cfg, n_replicas=2, n_slots=2,
                          cache_len=48, placement="round-robin",
                          handover="migrate", max_window=2)
    for i in range(4):
        cluster.submit(Request(rid=i, prompt=_prompt(cfg, i),
                               max_new_tokens=10))
    for _ in range(2):
        cluster.step()
    busy = cluster.replicas[1]
    assert busy.active
    assert cluster.scale_down(1) == 1 and 1 in cluster.retired
    done = cluster.run([Request(rid=10 + i, prompt=_prompt(cfg, 10 + i),
                                max_new_tokens=4) for i in range(3)])
    st = cluster.stats()
    assert st["requests_finished"] == 7 and len(done) == 7
    assert st["migrations"] >= 1 and not busy.active
    assert all(cluster._home[10 + i] == 0 for i in range(3))
    assert cluster.scale_up() == 1 and not cluster.retired
    assert len(cluster.replicas) == 2 and cluster.scale_ups == 1
    assert [e[1] for e in cluster.scale_events] == ["down", "up"]
    assert cluster.scale_down(0) == 0 and cluster.scale_down(1) is None


def test_cluster_rejects_cells_it_does_not_front(model):
    cfg, params = model
    cluster = EdgeCluster(params, cfg, n_replicas=2, n_slots=1, cache_len=32)
    ch = MobilityChannel([0, 2], [1e8, 1e8, 1e8])
    with pytest.raises(ValueError, match="only 2 replicas"):
        cluster.submit(Request(rid=0, prompt=_prompt(cfg, 0),
                               max_new_tokens=2, channel=ch))
