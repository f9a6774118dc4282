"""The dense archs stablelm-3b (layernorm with a bias, full MHA, head_dim
80), granite-8b (a tied LM head on the paged pool, GQA, rope theta 1e7) and
internlm2-20b (GQA) in the port against the JAX package.

Each runs on its reduced config in float32, with weights converted from
JAX's ``init_split_params`` and numpy-seeded tokens, through both
packages: ``T.prefill`` / ``T.decode_step``; ``split_prefill_mixed`` /
``split_decode_step_mixed`` on a paged arena with mixed modes; the
continuous-batching engine (paged pool, per-request channels) and the
synchronous ``ServingEngine`` under an orchestrator. A variant of the
reduced stablelm-3b at d_model 160 with 2 heads (head_dim 80 = d_model /
n_heads, as in the full model) runs the paged engine too.

Logits are held to ``LOGIT_RTOL`` times the largest logit, as in
``tests/test_torch_sync_engine.py`` (f32 sums in other orders through two
layers); arenas and decode states likewise. Tokens, per-tick modes, wire
bytes and the tick-exact lifecycle must be equal. The port's three full
configs must equal the reference's field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_reduced as j_reduced
from repro.core import bottleneck as JB
from repro.core import split as JSP
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.channel import channel_fleet as j_fleet
from repro.core.orchestrator import (AppRequirement as JReq,
                                     ModeProfile as JProfile,
                                     Orchestrator as JOrch)
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JSyncEngine
from repro.training import checkpoint
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core import split as TSP
from repro_torch.core.channel import ChannelConfig as TChannelConfig
from repro_torch.core.channel import channel_fleet as t_fleet
from repro_torch.core.channel import tx_seconds
from repro_torch.core.orchestrator import (AppRequirement as TReq,
                                           ModeProfile as TProfile,
                                           Orchestrator as TOrch)
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TSyncEngine

ARCHS = ("stablelm-3b", "granite-8b", "internlm2-20b")
HD80 = "stablelm-3b d160"      # the reduced stablelm-3b at d_model 160
LOGIT_RTOL = 2e-6
B, S, CACHE, PAGE = 3, 8, 32, 8
LENS = np.array([8, 5, 3], np.int32)
N_REQ = 6


def _cfg(get, arch):
    name = HD80 if arch == HD80 else None
    cfg = dataclasses.replace(get("stablelm-3b" if name else arch),
                              dtype="float32")
    if name:
        cfg = dataclasses.replace(cfg, d_model=160, n_heads=2, n_kv_heads=2,
                                  head_dim=80)
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference(arch):
    assert arch in ARCH_IDS
    for tget, jget in ((t_config, j_config), (t_reduced, j_reduced)):
        got, want = dataclasses.asdict(tget(arch)), dataclasses.asdict(
            jget(arch))
        assert got == want
    assert t_config("stablelm-3b").head_dim == 80
    assert t_reduced("stablelm-3b").head_dim == 80


@pytest.fixture(scope="module")
def models():
    """(jax config, torch config, JAX weights, their conversion) of an
    arch, made once per module."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg, tcfg = _cfg(j_reduced, arch), _cfg(t_reduced, arch)
            jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
            made[arch] = (jcfg, tcfg, jp, params_from_flat(
                checkpoint._flatten(jp), device="cpu"))
        return made[arch]
    return get


@pytest.fixture(scope="module", params=ARCHS)
def setup(request, models):
    jcfg, tcfg, jp, tp = models(request.param)
    toks = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tp, toks


def _close(got, want, floor=0.0):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * max(
        np.abs(want).max(), floor))


def test_prefill_and_decode_step_match_jax(setup):
    """``T.prefill`` over ragged rows into the dense cache, then two
    ``T.decode_step`` calls: logits, the caches and the fused tail's
    tokens."""
    jcfg, tcfg, jp, tp, toks = setup
    jl, jst = JT.prefill(jp, jnp.asarray(toks), jcfg,
                         JT.init_decode_state(jcfg, B, CACHE),
                         lengths=jnp.asarray(LENS))
    tl, tst = TT.prefill(tp, torch.from_numpy(toks), tcfg,
                         TT.init_decode_state(tcfg, B, CACHE),
                         lengths=torch.from_numpy(LENS))
    _close(tl, jl)
    tok, pos = np.argmax(np.asarray(jl), -1).astype(np.int32), LENS.copy()
    for _ in range(2):
        jl, jst = JT.decode_step(jp, jnp.asarray(tok), jst, jnp.asarray(pos),
                                 jcfg)
        st = TT.tree_map(lambda a: a.clone(), tst)
        ttok, _ = TT.decode_step(tp, torch.from_numpy(tok), st,
                                 torch.from_numpy(pos), tcfg,
                                 return_tokens=True)
        tl, tst = TT.decode_step(tp, torch.from_numpy(tok), tst,
                                 torch.from_numpy(pos), tcfg)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        assert np.array_equal(ttok.numpy(), tok)
        pos = pos + 1
    for k in ("k", "v"):
        _close(tst[k], jst[k], floor=1.0)


def _tables(lens, extra):
    """Block tables for each row's prompt plus ``extra`` decode rows, pages
    handed out shuffled, unallocated entries at scratch page 0."""
    need = [-(-(int(n) + extra) // PAGE) for n in lens]
    nb, n_pages = max(need), sum(need)
    free = list(np.random.default_rng(1).permutation(np.arange(
        1, n_pages + 1)))
    bt = np.zeros((len(lens), nb), np.int32)
    for b, n in enumerate(need):
        for j in range(n):
            bt[b, j] = free.pop()
    return bt, n_pages


def test_split_paged_prefill_and_mixed_decode_match_jax(setup):
    """``split_prefill_mixed`` into a paged arena, then two
    ``split_decode_step_mixed`` ticks with the modes rolling over the
    rows: logits, the arena, and the fused tail's tokens."""
    jcfg, tcfg, jp, tp, toks = setup
    steps = 2
    bt, n_pages = _tables(LENS, steps)
    modes = np.array([0, 1, 1], np.int32)
    jstack = JB.bank_stack(jp["bneck_modes"], jcfg.split)
    tstack = TB.bank_stack(tp["bneck_modes"], tcfg.split)
    jl, jst = JSP.split_prefill_mixed(
        jp, jstack, jnp.asarray(toks), JT.init_decode_state(
            jcfg, n_pages + 1, PAGE), jcfg, jnp.asarray(modes),
        lengths=jnp.asarray(LENS), block_table=jnp.asarray(bt))
    tl, tst = TSP.split_prefill_mixed(
        tp, tstack, torch.from_numpy(toks), TT.init_decode_state(
            tcfg, n_pages + 1, PAGE), tcfg, torch.from_numpy(modes),
        lengths=torch.from_numpy(LENS), block_table=torch.from_numpy(bt))
    _close(tl, jl)
    tok, pos = np.array(jnp.argmax(jl, -1), np.int32), LENS.copy()
    for step in range(steps):
        m = np.roll(modes, step)
        jl, jst = JSP.split_decode_step_mixed(
            jp, jstack, jnp.asarray(tok), jst, jnp.asarray(pos), jcfg,
            jnp.asarray(m), block_table=jnp.asarray(bt))
        args = (tp, tstack, torch.from_numpy(tok), tst,
                torch.from_numpy(pos), tcfg, torch.from_numpy(m),
                torch.from_numpy(bt))
        # the fused tail first: it writes the same K/V rows again
        tt, _ = TSP.split_decode_step_mixed(*args, return_tokens=True)
        tl, tst = TSP.split_decode_step_mixed(*args)
        _close(tl, jl)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tt.numpy(), tok)
        pos = pos + 1
    for k in ("k", "v"):
        _close(tst[k], jst[k], floor=1.0)


def _requests(cfg, fleet, chan_cfg, request_cls):
    chans = fleet(N_REQ, chan_cfg(mean_mbps=0.5, std_mbps=0.4,
                                  blockage_prob=0.08, recovery_prob=0.15),
                  seed=11, mean_spread=0.95)
    rng = np.random.default_rng(3)
    return [request_cls(rid=i, prompt=rng.integers(
                1, cfg.vocab_size, size=int(rng.integers(5, 9))).astype(
                    np.int32),
            max_new_tokens=int(rng.integers(2, 8)), channel=chans[i],
            arrival_tick=i // 2) for i in range(N_REQ)]


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


@pytest.mark.parametrize("arch", [*ARCHS, HD80])
def test_continuous_engine_matches_jax(arch, models):
    """The paged engine of both packages on the same requests (five pages:
    requests park until retirements free pages): per-request tokens, mode
    traces, wire bytes and lifecycle, and the engine's counters."""
    jcfg, tcfg, jp, tp = models(arch)
    want = _continuous(JEngine, jcfg, jp, JB, j_fleet, JChannelConfig,
                       JRequest, JProfile, JReq, JOrch)
    got = _continuous(TEngine, tcfg, tp, TB, t_fleet, TChannelConfig,
                      TRequest, TProfile, TReq, TOrch)
    assert got == want
    assert got[1]["paged"] and len(got[1]["mode_counts"]) > 1
    assert got[1]["requests_finished"] == N_REQ


def test_sync_engine_matches_jax(setup):
    """``ServingEngine.prefill`` + ``decode_tokens`` under an orchestrator
    fed a link that drops and recovers: the same tokens, wire bytes and
    mode counts, at least two modes used."""
    jcfg, tcfg, jp, tp, toks = setup
    # a budget that mode 0's payload meets at the fast rate only
    budget = tx_seconds(1.5 * TB.mode_payload_bytes(tcfg, B, 1, 0), 1e8)
    outs = []
    for eng_cls, cfg, params, mod in ((JSyncEngine, jcfg, jp, jserve),
                                      (TSyncEngine, tcfg, tp, tserve)):
        orch = mod.build_orchestrator(cfg, B, budget)
        eng = eng_cls(params, cfg, cache_len=CACHE, batch=B,
                      orchestrator=orch)
        first = np.argmax(np.asarray(eng.prefill(toks)), -1).astype(np.int32)
        caps = iter([1e8] * 2 + [1e3] * 4 + [1e8] * 10)
        gen = eng.decode_tokens(first, 8, capacity_bps_fn=lambda: next(caps))
        outs.append((np.asarray(gen).tolist(), eng.stats.wire_bytes,
                     dict(eng.stats.mode_counts)))
    assert outs[1] == outs[0]
    assert len(outs[1][2]) >= 2
