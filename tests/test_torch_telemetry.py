"""The port's serving telemetry against the JAX package's.

The metrics registry and the trace recorder are the reference's code on
numpy: the same observations must give the same histogram quantiles,
JSON snapshot, Prometheus text and Chrome-trace events. Attached to an
engine, telemetry must change no token on either pool and either loop
(qwen2.5-3b paged, recurrentgemma-2b dense), and the engine's host events,
counters and folded per-tick block (``device_tel``) must equal the
reference engine's on the same requests (reduced qwen2.5-3b in float32,
weights converted from JAX's ``init_split_params``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.channel import channel_fleet as j_fleet
from repro.models import sharding as j_sharding
from repro.serving import batcher as JB
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import default_orchestrator as j_orch
from repro.serving import telemetry as JT
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import split as TSP
from repro_torch.core.channel import ChannelConfig as TChannelConfig
from repro_torch.core.channel import channel_fleet as t_fleet
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import default_orchestrator as t_orch
from repro_torch.serving import telemetry as PT

N_REQ = 8


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


def _feed(tel, seed: int):
    """The same counters, gauges and (weighted) observations, including
    values past the histogram's range."""
    rng = np.random.default_rng(seed)
    for i in range(300):
        tel.observe("lat_s", float(rng.lognormal(-6, 2)),
                    int(rng.integers(1, 4)))
        tel.inc("bytes", int(rng.integers(0, 5000)))
        if i % 7 == 0:
            tel.set("engine.queue_depth", int(rng.integers(0, 9)))
    tel.observe("lat_s", 500.0)
    tel.registry.histogram("narrow_s", lo=1e-3, hi=1.0, n_buckets=8)
    for v in rng.uniform(0, 2, 50):
        tel.observe("narrow_s", float(v))
    tel.registry.ingest("engine.stats", {"a": 1, "b": {"c": 2.5},
                                         "skip": "text", "flag": True})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_quantiles_snapshot_and_prometheus_match(seed):
    j, p = JT.Telemetry(), PT.Telemetry()
    _feed(j, seed)
    _feed(p, seed)
    hj, hp = j.registry.get("lat_s"), p.registry.get("lat_s")
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert hp.quantile(q) == hj.quantile(q)
    assert p.registry.snapshot() == j.registry.snapshot()
    assert p.registry.prometheus() == j.registry.prometheus()
    names = ("lat_s", "narrow_s", "missing_s")
    assert p.registry.latency_summary(*names) == \
        j.registry.latency_summary(*names)
    p.registry.reset()
    j.registry.reset()
    assert p.registry.snapshot() == j.registry.snapshot()
    with pytest.raises(TypeError):
        p.registry.counter("lat_s")


def _trace(mod, capacity: int):
    tel = mod.Telemetry(trace_capacity=capacity, lane_name="cluster")
    tel.trace.t0 = 100.0
    r0 = tel.for_lane(1, "replica0")
    r1 = tel.for_lane(2, "replica1")
    for i in range(12):
        tel.instant("slo_admission", cat="admission", t=100.0 + i * 1e-3,
                    rid=i, verdict="admit")
        r0.complete("window_dispatch", 100.0 + i * 2e-3, 5e-4,
                    cat="window", k=4, live=2, tick=i)
        r1.instant("migrate_inject", cat="migration", t=100.5 + i * 1e-3,
                   rid=i, to_replica=1)
    return tel


@pytest.mark.parametrize("capacity", [8, 1000])
def test_chrome_trace_matches(capacity, tmp_path):
    """Lanes, events, the ring buffer's drops and the exported JSON."""
    j, p = _trace(JT, capacity), _trace(PT, capacity)
    assert p.trace.chrome_trace() == j.trace.chrome_trace()
    assert p.trace.dropped == j.trace.dropped
    import json
    path = p.trace.export(str(tmp_path / "t.json"))
    assert json.load(open(path)) == json.loads(json.dumps(
        j.trace.chrome_trace()))


def test_stopwatch_best_of_and_profile_capture(tmp_path):
    with PT.Stopwatch() as sw:
        assert sw.lap() >= 0.0
    assert sw.seconds >= 0.0
    best, out = PT.best_of(lambda x: x + 1, 1, repeats=2)
    assert out == 2 and best >= 0.0
    with PT.profile_capture(None) as prof:
        assert prof is None
    with PT.profile_capture(str(tmp_path / "prof")) as prof:
        torch.ones(3).sum()
    assert (tmp_path / "prof" / "trace.json").exists()


# ---------------------------------------------------------------------------
# engines: no token changes; events, counters and device_tel as the reference
# ---------------------------------------------------------------------------

def _requests(cfg, fleet, chan_cfg, request_cls):
    # links around the mode-0 / mode-1 boundary with frequent blockage:
    # sessions switch modes mid-stream
    chans = fleet(N_REQ, chan_cfg(mean_mbps=30.0, std_mbps=30.0,
                                  blockage_prob=0.3, recovery_prob=0.3),
                  seed=11, mean_spread=0.95)
    rng = np.random.default_rng(3)
    return [request_cls(
        rid=i, prompt=rng.integers(1, cfg.vocab_size, size=int(
            rng.integers(3, 10))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 10)), channel=chans[i],
        arrival_tick=i // 2) for i in range(N_REQ)]


def _run_port(params, cfg, *, host_loop, telemetry, **kw):
    tel = PT.Telemetry() if telemetry else None
    eng = TEngine(params, cfg, n_slots=3, cache_len=32,
                  orchestrator=t_orch(cfg), host_loop=host_loop,
                  telemetry=tel, **kw)
    done = eng.run(_requests(cfg, t_fleet, TChannelConfig, TRequest))
    eng.close()
    assert eng.pool.n_free == eng.pool.n_slots
    return done, eng.stats(), tel, eng


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b"])
@pytest.mark.parametrize("host_loop", [False, True])
def test_telemetry_changes_no_token_bits(arch, host_loop):
    """The instrumented engine decodes the plain engine's streams (tokens,
    modes, wire bytes, lifecycle ticks) and stats; its registry saw the
    run, and on the device loop the folded block equals host accounting."""
    cfg = t_reduced(arch)
    params = TSP.init_split_params(torch.Generator().manual_seed(0), cfg)
    pd, pst, _, _ = _run_port(params, cfg, host_loop=host_loop,
                              telemetry=False)
    td, tst, tel, eng = _run_port(params, cfg, host_loop=host_loop,
                                  telemetry=True)
    plain = {s.request.rid: s for s in pd}
    instr = {s.request.rid: s for s in td}
    assert plain.keys() == instr.keys() and len(plain) == N_REQ
    for rid in plain:
        a, b = plain[rid], instr[rid]
        assert (a.tokens, a.mode_counts, a.wire_bytes, a.admitted_tick,
                a.finished_tick) == (b.tokens, b.mode_counts, b.wire_bytes,
                                     b.admitted_tick, b.finished_tick), rid
    assert {k: v for k, v in pst.items() if k != "mean_ttft_s"} == \
        {k: v for k, v in tst.items() if k != "mean_ttft_s"}
    snap = tel.registry.snapshot()
    assert snap["engine.ttft_s"]["count"] == N_REQ
    assert snap["engine.decode_wire_bytes"] == tst["decode_wire_bytes"]
    assert snap["engine.stats.decode_ticks"] == tst["decode_ticks"]
    if not host_loop:
        assert eng.device_tel["wire_bytes"] == tst["decode_wire_bytes"]
        assert eng.device_tel["slot_ticks"] == tst["decode_tokens"]
        assert int(eng.device_tel["mode_ticks"].sum()) == \
            eng.device_tel["slot_ticks"]
        assert {m: int(c) for m, c in enumerate(eng.device_tel["mode_ticks"])
                if c} == tst["mode_counts"]


def _events(tel):
    """Trace events without their times: (name, cat, lane, args)."""
    return [(e["name"], e["cat"], e["pid"], e["args"])
            for e in tel.trace.events()]


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's instrumented engine on the device loop (reduced
    qwen2.5-3b, f32) and the port's on the converted weights."""
    jcfg = dataclasses.replace(j_reduced("qwen2.5-3b"), dtype="float32")
    tcfg = dataclasses.replace(t_reduced("qwen2.5-3b"), dtype="float32")
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    jtel = JT.Telemetry()
    jeng = JEngine(jp, jcfg, n_slots=3, cache_len=32,
                   orchestrator=j_orch(jcfg), max_window=4, telemetry=jtel)
    jdone = jeng.run(_requests(jcfg, j_fleet, JChannelConfig, JRequest))
    jst = jeng.stats()
    jeng.close()
    td, tst, ttel, teng = _run_port(tp, tcfg, host_loop=False,
                                    telemetry=True, max_window=4)
    return (jdone, jst, jtel, jeng), (td, tst, ttel, teng)


def test_device_tel_and_counters_match_reference(reference_runs):
    (jdone, jst, jtel, jeng), (td, tst, ttel, teng) = reference_runs
    assert teng.device_tel["wire_bytes"] == jeng.device_tel["wire_bytes"]
    assert teng.device_tel["slot_ticks"] == jeng.device_tel["slot_ticks"]
    assert np.array_equal(teng.device_tel["mode_ticks"],
                          jeng.device_tel["mode_ticks"])
    js, ts = jtel.registry.snapshot(), ttel.registry.snapshot()
    assert set(ts) == set(js)
    for name, v in js.items():
        if isinstance(v, dict):                # histograms: counts only
            assert ts[name]["count"] == v["count"], name
        elif name != "engine.stats.mean_ttft_s":
            assert ts[name] == v, name
    assert {s.request.rid: s.tokens for s in td} == \
        {s.request.rid: s.tokens for s in jdone}


def test_trace_events_match_reference(reference_runs):
    """Every host event the reference records — admissions, prefill and
    window spans, mode switches — in the same order with the same args."""
    (_, _, jtel, _), (_, _, ttel, _) = reference_runs
    got, want = _events(ttel), _events(jtel)
    assert got == want
    names = {e[0] for e in want}
    assert {"admit", "prefill", "window_dispatch", "window_materialize",
            "mode_switch"} <= names
