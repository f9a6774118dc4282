"""Serving the frontend archs in the port against the JAX package:
musicgen-large (``[K, S]`` codebook prompts, ``[K, 1]`` tokens a slot, a
session recording codebook 0's token) and llava-next-34b (text prompts)
on the continuous engine (paged pool) and the synchronous engine; an
audio session's live migration and its snapshot; drop-and-replay of an
audio prompt; the launchers.

Reduced configs in float32, weights from the JAX init carried across by
``repro_torch.convert``, numpy-seeded prompts. Tokens, per-tick modes,
wire bytes, the tick-exact lifecycle and snapshot bytes must be equal; a
snapshot's raw leaves within 1e-5 (the plain path's f32 sums in other
orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import bottleneck as JB
from repro.core import split as JSP
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.channel import MobilityChannel as JMobility
from repro.core.channel import channel_fleet as j_fleet
from repro.core.orchestrator import (AppRequirement as JReq,
                                     ModeProfile as JProfile,
                                     Orchestrator as JOrch)
from repro.launch import serve as jserve
from repro.models import sharding as j_sharding
from repro.serving import batcher as JBatcher
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JSyncEngine
from repro.serving import default_orchestrator as j_orch
from repro.serving import extract_session as j_extract
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core.channel import ChannelConfig as TChannelConfig
from repro_torch.core.channel import MobilityChannel
from repro_torch.core.channel import channel_fleet as t_fleet
from repro_torch.core.channel import tx_seconds
from repro_torch.core.orchestrator import (AppRequirement as TReq,
                                           ModeProfile as TProfile,
                                           Orchestrator as TOrch)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import (EdgeCluster, Request, ServingEngine,
                                 default_orchestrator, extract_session)

ARCHS = ("musicgen-large", "llava-next-34b")
N_REQ = 6


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
    """The reference's paged pool hands rows of its numpy block table to
    work that runs later, which races under CPU load (ROADMAP Queue 3):
    give the window a copy, as ``tests/test_torch_migration.py`` does."""
    def block_table(self):
        return j_sharding.shard_batch(jax.numpy.asarray(
            self.block_np[:, :self.table_width()].copy()), self.mesh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBatcher.PagedPool, "block_table", block_table)
        yield


@pytest.fixture(scope="module")
def models():
    """(jax config, torch config, JAX weights, their conversion) of an
    arch in float32, made once per module."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
            tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
            jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
            made[arch] = (jcfg, tcfg, jp, params_from_flat(
                checkpoint._flatten(jp), device="cpu"))
        return made[arch]
    return get


def _prompt(cfg, n: int, rng):
    shape = (cfg.n_codebooks, n) if cfg.frontend == "audio" else (n,)
    return rng.integers(1, cfg.vocab_size, size=shape).astype(np.int32)


def _requests(cfg, fleet, chan_cfg, request_cls):
    chans = fleet(N_REQ, chan_cfg(mean_mbps=0.5, std_mbps=0.4,
                                  blockage_prob=0.08, recovery_prob=0.15),
                  seed=11, mean_spread=0.95)
    rng = np.random.default_rng(3)
    return [request_cls(rid=i, prompt=_prompt(cfg, int(rng.integers(5, 9)),
                                              rng),
                        max_new_tokens=int(rng.integers(2, 8)),
                        channel=chans[i], arrival_tick=i // 2)
            for i in range(N_REQ)]


def _continuous(eng_cls, cfg, params, bn, fleet, chan_cfg, request_cls,
                profile, req, orch):
    orch = orch([profile(m, bn.mode_payload_bytes(cfg, 1, 1, m), float(m))
                 for m in range(cfg.split.n_modes)],
                req(latency_budget_s=0.006), ema=0.5, hysteresis=1.0)
    eng = eng_cls(params, cfg, orchestrator=orch, n_slots=3, cache_len=32,
                  page_len=8, n_pages=5)
    done = eng.run(_requests(cfg, fleet, chan_cfg, request_cls))
    st = eng.stats()
    per = {s.request.rid: (list(s.tokens), [tuple(t) for t in s.mode_trace],
                           s.wire_bytes, s.admitted_tick, s.finished_tick)
           for s in done}
    keys = ("paged", "decode_ticks", "mixed_mode_ticks", "wire_bytes",
            "prefill_calls", "mode_counts", "requests_finished",
            "peak_pages_in_use", "requests_parked")
    return per, {k: st[k] for k in keys}


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_reference(arch, models):
    """The paged engine of both packages on the same requests (five
    pages: requests park until retirements free pages): per-request
    tokens (codebook 0's for audio), mode traces, wire bytes and
    lifecycle, and the engine's counters."""
    jcfg, tcfg, jp, tp = models(arch)
    want = _continuous(JEngine, jcfg, jp, JB, j_fleet, JChannelConfig,
                       JRequest, JProfile, JReq, JOrch)
    got = _continuous(TEngine, tcfg, tp, TB, t_fleet, TChannelConfig,
                      Request, TProfile, TReq, TOrch)
    assert got == want
    assert got[1]["paged"] and len(got[1]["mode_counts"]) > 1
    assert got[1]["requests_finished"] == N_REQ


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_engine_matches_reference(arch, models):
    """``ServingEngine.prefill`` + ``decode_tokens`` under an orchestrator
    fed one capacity trace: every token (``[B, K, n]`` for audio), the
    mode counts and the wire bytes."""
    jcfg, tcfg, jp, tp = models(arch)
    B, S, n = 2, 6, 8
    rng = np.random.default_rng(4)
    toks = np.stack([_prompt(jcfg, S, rng) for _ in range(B)])
    # a budget that mode 0's payload meets at the fast rate only
    budget = tx_seconds(1.5 * TB.mode_payload_bytes(tcfg, B, 1, 0), 1e8)

    def run(eng_cls, cfg, params, mod, asarray):
        eng = eng_cls(params, cfg, cache_len=16, batch=B,
                      orchestrator=mod.build_orchestrator(cfg, B, budget))
        logits = eng.prefill(asarray(toks))
        first = np.argmax(np.asarray(logits), -1).astype(np.int32)
        caps = iter([1e8] * 2 + [1e3] * 4 + [1e8] * 10)
        out = eng.decode_tokens(asarray(first), n,
                                capacity_bps_fn=lambda: next(caps))
        return (np.asarray(out), eng.stats.tokens, eng.stats.wire_bytes,
                dict(eng.stats.mode_counts))

    want = run(JSyncEngine, jcfg, jp, jserve, jnp.asarray)
    got = run(ServingEngine, tcfg, tp, tserve, torch.from_numpy)
    assert got[0].shape == want[0].shape == toks.shape[:-1] + (n,)
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:] and len(got[3]) > 1


def _mobility(cross_at, *, n_ticks=64, mod=MobilityChannel):
    return mod([0] * cross_at + [1] * n_ticks, [2e6, 2e6], detach_factor=1.0)


def _audio_requests(cfg):
    rng = np.random.default_rng(6)
    return [Request(rid=0, prompt=_prompt(cfg, 4, rng), max_new_tokens=12,
                    channel=_mobility(5)),
            Request(rid=1, prompt=_prompt(cfg, 4, rng), max_new_tokens=9,
                    channel=_mobility(60))]


def test_audio_session_migrates_bit_identical(models):
    """A musicgen-large session crosses cells mid-generation and
    live-migrates raw in a 2-replica cluster; another never moves. Both
    decode what one unmigrated engine decodes, and the snapshot carries
    the session's [K, 1] token row, charged 4 bytes a codebook value."""
    _, cfg, _, params = models("musicgen-large")
    eng = TEngine(params, cfg, n_slots=2, cache_len=48,
                  orchestrator=default_orchestrator(cfg))
    base = {s.request.rid: s for s in eng.run(_audio_requests(cfg))}
    cluster = EdgeCluster(params, cfg, n_replicas=2, n_slots=2, cache_len=48,
                          placement="best-channel", handover="migrate")
    got = {s.request.rid: s for s in cluster.run(_audio_requests(cfg))}
    st = cluster.stats()
    cluster.close()
    assert st["migrations"] == 1 and st["requests_finished"] == 2
    for rid in base:
        assert got[rid].tokens == base[rid].tokens
        assert got[rid].wire_bytes == base[rid].wire_bytes
    assert got[0].migrations[0]["kind"] == "migrate"
    # the snapshot against the reference's, on the same session
    jcfg, tcfg, jp, tp = models("musicgen-large")
    snaps = []
    for eng_cls, req_cls, orch, mob, c, p, extract in (
            (JEngine, JRequest, j_orch, JMobility, jcfg, jp, j_extract),
            (TEngine, Request, default_orchestrator, MobilityChannel, tcfg,
             tp, extract_session)):
        e = eng_cls(p, c, n_slots=2, cache_len=32, orchestrator=orch(c),
                    host_loop=True)
        rng = np.random.default_rng(8)
        for i in range(2):
            e.submit(req_cls(rid=i, prompt=_prompt(c, 6, rng),
                             max_new_tokens=12,
                             channel=_mobility(60, mod=mob)))
        for _ in range(5):
            e.step()
        snaps.append(extract(e, 1, bits=0))
    js, ts = snaps
    assert ts.cur_token.shape == (cfg.n_codebooks, 1)
    assert np.array_equal(ts.cur_token, np.asarray(js.cur_token))
    assert ts.nbytes == js.nbytes
    state = sum(a[1].nbytes for a in ts.wire)
    assert ts.nbytes == state + 16 + 4 * cfg.n_codebooks
    assert ts.session.tokens == js.session.tokens
    for a, b in zip(ts.wire, js.wire):
        np.testing.assert_allclose(a[1], np.asarray(b[1], a[1].dtype),
                                   rtol=1e-5, atol=1e-5)


def test_audio_drop_and_replay_raises(models):
    """Drop-and-replay cannot rebuild a multi-codebook prompt from the
    emitted codebook-0 stream: the cluster raises, as the reference's."""
    _, cfg, _, params = models("musicgen-large")
    cluster = EdgeCluster(params, cfg, n_replicas=2, n_slots=2, cache_len=48,
                          placement="best-channel", handover="drop")
    with pytest.raises(NotImplementedError, match="multi-codebook"):
        cluster.run(_audio_requests(cfg))
    cluster.close()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ["sync", "continuous"])
def test_serve_launcher(arch, engine):
    """``launch.serve`` on the CPU at reduced shapes: every request
    finishes with ``--gen`` tokens in the vocabulary (sync: K rows a
    request for audio)."""
    cfg = t_reduced(arch)
    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--engine", engine, "--requests", "3", "--gen", "4",
                       "--prompt-len", "6", "--n-slots", "2"])
    if engine == "sync":
        gen = np.asarray(out["generated"])
        lead = (3, cfg.n_codebooks) if cfg.frontend == "audio" else (3,)
        assert gen.shape == lead + (4,)
        assert out["tokens"] == gen.size
    else:
        assert out["requests_finished"] == 3
        gen = np.asarray(list(out["tokens"].values()))
        assert gen.shape == (3, 4)
    assert gen.min() >= 0 and gen.max() < cfg.vocab_size


def test_train_launcher_vision(tmp_path):
    """``launch.train`` on llava-next-34b at reduced shapes: the vision
    prefix from ``make_batch`` before the Markov text (``--seq`` in all),
    finite losses, a checkpoint."""
    hist = ttrain.main(["--arch", "llava-next-34b", "--reduced", "--device",
                        "cpu", "--steps", "2", "--batch", "2", "--seq", "24",
                        "--ckpt-dir", str(tmp_path)])
    losses = [r["loss"] for r in hist["phase1"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp_path / "llava-next-34b.npz").exists()
