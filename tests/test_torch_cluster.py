"""The port's ``EdgeCluster`` against the JAX package's.

The same mobility requests (each UE crosses from its home cell into the
next partway through generation, at a detached capacity that makes staying
costly) through both packages' clusters, for every placement and handover
policy, on reduced qwen2.5-3b in float32 with weights converted from JAX's
``init_split_params``: every session's tokens, modes, wire bytes, transfer
time, migration records and handover ticks, and the whole ``stats()``
(migrations, ``migration_bytes``, handovers, replays, per-replica
counters) must be equal. Then a fleet of Lumos5G trace lanes through SLO
admission and the autoscaler: the same admissions, rejections and scale
events.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.core.channel import FleetChannel as JFleet
from repro.core.channel import MobilityChannel as JMobility
from repro.models import sharding as j_sharding
from repro.serving import batcher as JB
from repro.serving import Autoscaler as JAutoscaler
from repro.serving import AutoscalerConfig as JAutoscalerConfig
from repro.serving import EdgeCluster as JCluster
from repro.serving import FleetLoadConfig as JLoad
from repro.serving import Request as JRequest
from repro.serving import SLOAdmission as JAdmission
from repro.serving import fleet_requests as j_fleet_requests
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core.channel import FleetChannel as TFleet
from repro_torch.core.channel import MobilityChannel as TMobility
from repro_torch.data.lumos5g import capacity_traces_bps
from repro_torch.serving import Autoscaler as TAutoscaler
from repro_torch.serving import AutoscalerConfig as TAutoscalerConfig
from repro_torch.serving import EdgeCluster as TCluster
from repro_torch.serving import FleetLoadConfig as TLoad
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SLOAdmission as TAdmission
from repro_torch.serving import fleet_requests as t_fleet_requests

N_REQ = 6
GEN = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced shapes: one intra-op thread is enough, and the test workers
    beside this one keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _reference_block_tables_copied():
    """On the CPU ``jnp.asarray`` may alias a numpy array, and the
    reference's paged pool hands rows of its numpy block table to work
    that runs later (the window, on the pipeline thread; the injection's
    page scatter, dispatched asynchronously) while the main thread zeroes
    the row of a session that finishes at dispatch: under load the
    reference's token streams then vary (ROADMAP Queue 3). Give the window
    a copy, as ``block_table``'s docstring promises, and let the scatter
    finish before ``write_pages`` returns."""
    write_pages = JB.PagedPool.write_pages

    def block_table(self):
        return j_sharding.shard_batch(jax.numpy.asarray(
            self.block_np[:, :self.table_width()].copy()), self.mesh)

    def write_pages_landed(self, slot, blocks, position):
        write_pages(self, slot, blocks, position)
        jax.block_until_ready(self.states)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB.PagedPool, "block_table", block_table)
        mp.setattr(JB.PagedPool, "write_pages", write_pages_landed)
        yield


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(j_reduced("qwen2.5-3b"), dtype="float32")
    tcfg = dataclasses.replace(t_reduced("qwen2.5-3b"), dtype="float32")
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jp), (tcfg, params_from_flat(checkpoint._flatten(jp),
                                               device="cpu"))


def _requests(cfg, mobility, request_cls):
    """Mobility sessions (as ``bench_cluster``): in-cell capacity fits every
    mode, detached capacity (x 0.02) fits none."""
    hi = 4.0 * TB.mode_payload_bytes(cfg, 1, 1, 0) / 0.002
    rng = np.random.default_rng(0)
    out = []
    for i in range(N_REQ):
        home = i % 2
        cross = int(rng.integers(2, GEN // 2))
        cells = [home] * cross + [1 - home] * (GEN + 8)
        out.append(request_cls(
            rid=i, prompt=rng.integers(1, cfg.vocab_size, size=int(
                rng.integers(3, 8))).astype(np.int32),
            max_new_tokens=GEN, arrival_tick=(i // 2) * 2,
            channel=mobility(cells, [hi, hi], detach_factor=0.02)))
    return out


def _session(s):
    return {"tokens": list(s.tokens), "wire_bytes": s.wire_bytes,
            "prefill_wire_bytes": s.prefill_wire_bytes,
            "mode_counts": dict(s.mode_counts),
            "mode_trace": [tuple(t) for t in s.mode_trace],
            "transfer_s": round(s.transfer_s, 9),
            "deadline_misses": s.deadline_misses,
            "migrations": s.migrations, "handover_ticks": s.handover_ticks,
            "finished_tick": s.finished_tick}


def _run(cluster_cls, mobility, request_cls, cfg, params, **kw):
    cluster = cluster_cls(params, cfg, n_replicas=2, n_slots=2,
                          cache_len=64, max_window=4, **kw)
    done = cluster.run(_requests(cfg, mobility, request_cls))
    st = cluster.stats()
    cluster.close()
    return {s.request.rid: _session(s) for s in done}, st


@pytest.mark.parametrize("handover", ["migrate", "stay", "drop"])
@pytest.mark.parametrize("placement",
                         ["best-channel", "least-loaded", "round-robin"])
def test_cluster_matches_reference(placement, handover, weights):
    (jcfg, jp), (tcfg, tp) = weights
    kw = dict(placement=placement, handover=handover)
    jper, jst = _run(JCluster, JMobility, JRequest, jcfg, jp, **kw)
    tper, tst = _run(TCluster, TMobility, TRequest, tcfg, tp, **kw)
    assert tst == jst
    assert tper == jper and len(tper) == N_REQ
    assert tst["handovers"] > 0
    if handover == "migrate":
        assert tst["migrations"] > 0 and tst["migration_bytes"] > 0
    if handover == "drop":
        assert tst["replays"] > 0


def _fleet_run(mods, cfg, params):
    fleet_cls, load_cls, fleet_reqs, adm_cls, as_cls, as_cfg, cluster_cls = \
        mods
    n = 24
    fleet = fleet_cls(n, traces_bps=capacity_traces_bps(n, 128, seed=1),
                      cycle=True)
    reqs = fleet_reqs(fleet, load_cls(
        arrival="heavy-tail", mean_interarrival_ticks=0.6, prompt_len=4,
        prompt_len_jitter=1, max_new_tokens=5, vocab=cfg.vocab_size,
        slo_ticks=24, seed=2))
    min_pay = min(TB.mode_payload_bytes(cfg, 1, 1, m)
                  for m in range(cfg.split.n_modes))
    gate = adm_cls(min_pay)
    cluster = cluster_cls(
        params, cfg, n_replicas=1, n_slots=2, cache_len=32, max_window=4,
        admission=gate, max_pending=n,
        autoscaler=as_cls(as_cfg(max_replicas=3, sustain_ticks=1,
                                 cooldown_ticks=2, high_occupancy=0.6)))
    done = cluster.run_paced(reqs)
    st = cluster.stats()
    cluster.close()
    return ({s.request.rid: _session(s) for s in done}, st, gate.stats(),
            list(gate.events))


def test_fleet_admission_and_autoscaler_match_reference(weights):
    (jcfg, jp), (tcfg, tp) = weights
    jper, jst, jgate, jev = _fleet_run(
        (JFleet, JLoad, j_fleet_requests, JAdmission, JAutoscaler,
         JAutoscalerConfig, JCluster), jcfg, jp)
    tper, tst, tgate, tev = _fleet_run(
        (TFleet, TLoad, t_fleet_requests, TAdmission, TAutoscaler,
         TAutoscalerConfig, TCluster), tcfg, tp)
    assert tst == jst and tgate == jgate and tev == jev
    assert tper == jper
    c = tst["conservation"]
    assert c["in_flight"] == 0 and c["submitted"] == (
        c["finished"] + c["queue_rejected_router"]
        + c["queue_rejected_engine"] + c["over_capacity"]
        + c["slo_rejected"])
    assert tst["scale_ups"] > 0
