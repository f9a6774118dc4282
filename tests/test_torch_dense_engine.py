"""The port's continuous-batching engine on the dense slot pool against the
JAX package's.

Both engines serve the same requests (numpy prompts, per-request simulated
channels with the same seeds) on the reduced recurrentgemma-2b config in
float32 — RG-LRU and local-attention blocks, a tied LM head — with weights
converted from JAX's ``init_split_params``. A recurrent arch takes the
dense ``SlotPool`` (per-slot rolling caches and recurrent carries), and
prompts plus generations run past the local window, so the rolling cache
wraps. Per-tick modes, wire bytes, the tick-exact lifecycle and the
decoded tokens must be identical. Each JAX engine runs once per module and
loop kind.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import bottleneck as JB
from repro.core import split as JSP
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.channel import channel_fleet as j_fleet
from repro.core.orchestrator import (AppRequirement as JReq,
                                     ModeProfile as JProfile,
                                     Orchestrator as JOrch)
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import Request as JRequest
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core import split as TSP
from repro_torch.core.channel import ChannelConfig as TChannelConfig
from repro_torch.core.channel import channel_fleet as t_fleet
from repro_torch.core.orchestrator import (AppRequirement as TReq,
                                           ModeProfile as TProfile,
                                           Orchestrator as TOrch)
from repro_torch.launch import serve
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving.batcher import SlotPool

ARCH = "recurrentgemma-2b"
N_REQ = 8


def _cfgs():
    return (dataclasses.replace(j_reduced(ARCH), dtype="float32"),
            dataclasses.replace(t_reduced(ARCH), dtype="float32"))


def _requests(cfg, fleet, chan_cfg, request_cls):
    """Prompts of 3..40 tokens (local_window 32) and up to 12 new tokens."""
    chans = fleet(N_REQ, chan_cfg(mean_mbps=0.5, std_mbps=0.4,
                                  blockage_prob=0.08, recovery_prob=0.15),
                  seed=11, mean_spread=0.95)
    rng = np.random.default_rng(3)
    out = []
    for i in range(N_REQ):
        plen = int(rng.integers(3, 41))
        out.append(request_cls(
            rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                       size=plen).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 13)), channel=chans[i],
            arrival_tick=i // 2))
    return out


def _orch(cfg, bn, profile, req, orch):
    return orch([profile(m, bn.mode_payload_bytes(cfg, 1, 1, m), float(m))
                 for m in range(cfg.split.n_modes)],
                req(latency_budget_s=0.006), ema=0.5, hysteresis=1.0)


def _summary(eng, done):
    st = eng.stats()
    per = {s.request.rid: {"tokens": list(s.tokens),
                           "mode_trace": [tuple(t) for t in s.mode_trace],
                           "mode_counts": dict(s.mode_counts),
                           "wire_bytes": s.wire_bytes,
                           "transfer_s": round(s.transfer_s, 9),
                           "admitted_tick": s.admitted_tick,
                           "finished_tick": s.finished_tick}
           for s in done}
    keys = ("paged", "decode_ticks", "decoded_slot_ticks",
            "mixed_mode_ticks", "wire_bytes", "decode_wire_bytes",
            "prefill_calls", "prefill_tokens", "prefill_padded_tokens",
            "mode_counts", "mode_switches", "requests_finished",
            "requests_over_capacity", "requests_truncated",
            "deadline_misses", "mode_policy")
    return per, {k: st[k] for k in keys}


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_flat(checkpoint._flatten(jp), device="cpu")


ENGINE_KW = dict(n_slots=3, cache_len=32)


@pytest.fixture(scope="module", params=[True, False],
                ids=["host_loop", "device_window"])
def runs(request, weights):
    host_loop = request.param
    jcfg, tcfg = _cfgs()
    jp, tp = weights
    jeng = JEngine(jp, jcfg, host_loop=host_loop,
                   orchestrator=_orch(jcfg, JB, JProfile, JReq, JOrch),
                   **ENGINE_KW)
    jdone = jeng.run(_requests(jcfg, j_fleet, JChannelConfig, JRequest))
    jeng.close()
    teng = TEngine(tp, tcfg, host_loop=host_loop,
                   orchestrator=_orch(tcfg, TB, TProfile, TReq, TOrch),
                   **ENGINE_KW)
    assert isinstance(teng.pool, SlotPool) and not teng.paged
    tdone = teng.run(_requests(tcfg, t_fleet, TChannelConfig, TRequest))
    assert teng.pool.n_free == teng.pool.n_slots
    return _summary(jeng, jdone), _summary(teng, tdone)


def test_dense_engine_modes_and_wire_bytes_match(runs):
    (jper, jst), (tper, tst) = runs
    assert set(tper) == set(jper) and len(tper) == N_REQ
    for rid in jper:
        for k in ("mode_trace", "mode_counts", "wire_bytes", "transfer_s",
                  "admitted_tick", "finished_tick"):
            assert tper[rid][k] == jper[rid][k], (rid, k)
    assert tst == jst
    # the workload mixes modes on the dense pool
    assert tst["paged"] is False
    assert len(tst["mode_counts"]) > 1 and tst["mixed_mode_ticks"] > 0


def test_dense_engine_tokens_match(runs):
    (jper, _), (tper, _) = runs
    for rid in jper:
        assert tper[rid]["tokens"] == jper[rid]["tokens"], rid


def test_slot_pool_rows_round_trip(weights):
    """``write_rows(read_rows(s), s, pos)`` is an identity, and a write
    replaces every leaf of the slot's state (tuple-of-layers tree, slot
    axis 0)."""
    _, tcfg = _cfgs()
    pool = SlotPool(tcfg, 4, 32)
    gen = torch.Generator().manual_seed(0)
    for leaf in TT.tree_leaves(pool.states):
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    before = [a.clone() for a in TT.tree_leaves(pool.states)]
    rows = pool.read_rows([3, 1])
    assert TT.tree_leaves(rows)[0].shape[0] == 2
    pool.write_rows(rows, [3, 1], [7, 9])
    for a, b in zip(TT.tree_leaves(pool.states), before):
        assert torch.equal(a, b)
    assert list(pool.positions) == [0, 9, 0, 7]
    fresh = TT.init_decode_state(tcfg, 2, 32)
    pool.write_rows(fresh, [0, 2], [1, 1])
    for a, b in zip(TT.tree_leaves(pool.states), before):
        assert torch.equal(a[[0, 2]], torch.zeros_like(a[[0, 2]]))
        assert torch.equal(a[[1, 3]], b[[1, 3]])


def test_paged_false_serves_full_attention_from_the_dense_pool():
    """``paged=False`` selects the dense pool for a full-attention arch as
    well: qwen2.5-3b decodes the paged engine's tokens from per-slot
    caches, and ``paged=True`` on a recurrent arch raises."""
    cfg = dataclasses.replace(t_reduced("qwen2.5-3b"), dtype="float32")
    params = TSP.init_split_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 11, 3)]
    out = {}
    for paged in (True, False):
        eng = TEngine(params, cfg, n_slots=2, cache_len=24, paged=paged)
        assert isinstance(eng.pool, SlotPool) is (not paged)
        done = eng.run([TRequest(rid=i, prompt=p, max_new_tokens=6)
                        for i, p in enumerate(prompts)])
        out[paged] = {s.request.rid: list(s.tokens) for s in done}
        assert eng.stats()["paged"] is paged
    assert out[True] == out[False] and len(out[False]) == 3
    rcfg = dataclasses.replace(t_reduced(ARCH), dtype="float32")
    rparams = TSP.init_split_params(torch.Generator().manual_seed(0), rcfg)
    with pytest.raises(ValueError, match="paged=True"):
        TEngine(rparams, rcfg, paged=True)


def test_serve_recurrentgemma_cpu_and_refuses_cuda(monkeypatch):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "4", "--gen", "8"])
    assert out["requests_finished"] == 4 and out["paged"] is False
    assert all(len(t) == 8 for t in out["tokens"].values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--reduced", "--requests", "1",
                    "--gen", "2"])
