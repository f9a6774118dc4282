"""The mixture-of-experts archs phi3.5-moe-42b-a6.6b (16 experts, top 2,
full attention: the paged pool) and mixtral-8x7b (8 experts, top 2, a
sliding window: the dense rolling pool, window 64 in the reduced config)
in the port against the JAX package.

Each runs on its reduced config in float32, with weights converted from
JAX's ``init_split_params`` and numpy-seeded tokens, through both
packages: ``T.prefill`` / ``T.decode_step``; ``split_prefill_mixed`` /
``split_decode_step_mixed`` in mixed modes (on a paged arena for
phi3.5-moe, on the dense state for mixtral); the continuous-batching
engine and the synchronous ``ServingEngine`` under an orchestrator. The
mixtral runs decode past position 64, so its rolling window wraps.

Logits and caches are held to ``LOGIT_RTOL`` times their largest
magnitude (f32 sums in other orders through two layers, as in
``tests/test_torch_dense_archs.py``). Tokens, per-tick modes, wire bytes
and the tick-exact lifecycle must be equal. At decode every row is its
own routing group (N 1, capacity 1), so a dead slot beside a live one
changes nothing of the live row.

The first train step of ``training.loop.make_train_step`` in modes None, 0
and 1 (the loss with the load-balance aux, every gradient, every updated
leaf) follows ``tests/test_torch_train_loop.py``'s tolerances while the
8-bit wire codes of mode 1 equal the reference's. A code may move one
step where z / scale sits on a rounding edge, which the two sides' f32
sums may straddle (``tests/test_torch_kv_quant.py``): at most
``EDGE_LANES`` of the lanes, none by more than one step. One moved code
moves one element of the decoder's input by its row's scale, and with it
one token's loss and gradients: then the loss is held within
``FLIP_LOSS_REL`` and each gradient within ``FLIP_GRAD_REL`` of its scale
(the reduced mixtral's seed-0 batch moves one code of 1,024: its loss
parts by 7e-6 relative, its gradients by up to 1.6e-3 of their scale),
and Adam's first update may flip where |g| is under that tolerance. The MoE
leaves (``layers/mlp/router/w`` float32 ``[L, d, E]``, ``w_gate`` /
``w_up`` ``[L, E, d, f]``, ``w_down`` ``[L, E, f, d]``, bf16) cross both
ways bit for bit, and ``launch.train --cascade`` on phi3.5-moe writes a
checkpoint that the reference restores and ``launch.serve --ckpt`` serves.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import bottleneck as JB
from repro.core import split as JSP
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.channel import channel_fleet as j_fleet
from repro.core.orchestrator import (AppRequirement as JReq,
                                     ModeProfile as JProfile,
                                     Orchestrator as JOrch)
from repro.data import tokens as jtokens
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JSyncEngine
from repro.training import checkpoint as jckpt
from repro.training import loop as JL
from repro.training import optimizer as JO
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import (flat_from_params, flat_tensors,
                                 params_from_flat)
from repro_torch.core import bottleneck as TB
from repro_torch.core import cascade as TC
from repro_torch.core import split as TSP
from repro_torch.core.channel import ChannelConfig as TChannelConfig
from repro_torch.core.channel import channel_fleet as t_fleet
from repro_torch.core.channel import tx_seconds
from repro_torch.core.orchestrator import (AppRequirement as TReq,
                                           ModeProfile as TProfile,
                                           Orchestrator as TOrch)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TSyncEngine
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import loop as TL
from repro_torch.training import optimizer as TO

PHI, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x7b"
ARCHS = (PHI, MIXTRAL)
WINDOW = 64                      # the reduced mixtral's sliding window
LOGIT_RTOL = 2e-6
LOSS_ABS, LOSS_REL = 1e-5, 1e-6
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-3
STEP_REL, SMALL_G = 1e-5, 1e-3
EDGE_LANES = 1e-3
FLIP_LOSS_REL, FLIP_GRAD_REL = 1e-4, 1e-2
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=100)
B, S, PAGE = 3, 8, 8
LENS = np.array([8, 5, 3], np.int32)
# decode steps after the prefill: mixtral's row 0 ends at position 68,
# past the window
STEPS = {PHI: 3, MIXTRAL: 60}
CACHE = 96
N_REQ = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced shapes: one intra-op thread is enough, and the test workers
    beside this one keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
                jckpt._flatten(jp), device="cpu"))
        return made[arch]
    return get


def _close(got, want, floor=0.0):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * max(
        np.abs(want).max(), floor))


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)


def test_reduced_archs_are_moe():
    """Both archs build in the port with the reference's MoE widths; the
    layers' MoE leaves have the reference's shapes and dtypes; mixtral is
    windowed (the dense pool), phi3.5-moe is not (the paged pool)."""
    for arch in ARCHS:
        cfg = t_reduced(arch)
        assert cfg.is_moe and cfg.homogeneous
        p = TSP.init_split_params(torch.Generator().manual_seed(0), cfg)
        mlp = p["layers"]["mlp"]
        L, d, f, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
        assert mlp["router"]["w"].shape == (L, d, E)
        assert mlp["router"]["w"].dtype == torch.float32
        assert mlp["w_gate"].shape == mlp["w_up"].shape == (L, E, d, f)
        assert mlp["w_down"].shape == (L, E, f, d)
        assert mlp["w_gate"].dtype == torch.bfloat16
        assert TT.full_attention_arch(cfg) == (arch == PHI)
    assert t_reduced(MIXTRAL).sliding_window == WINDOW


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_jax(arch, models):
    """``T.prefill`` over ragged rows into the dense cache, then decode
    steps (mixtral past its window): logits, the fused tail's tokens and
    the caches; ``T.forward``'s logits and summed aux loss."""
    jcfg, tcfg, jp, tp = models(arch)
    toks = _tokens(jcfg)
    (jl, jaux) = jax.jit(lambda p, t: JT.forward(p, t, jcfg))(
        jp, jnp.asarray(toks))
    tl, taux = TT.forward(tp, torch.from_numpy(toks), tcfg)
    _close(tl, jl)
    assert float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    jl, jst = jax.jit(lambda p, t, s, n: JT.prefill(p, t, jcfg, s,
                                                    lengths=n))(
        jp, jnp.asarray(toks), JT.init_decode_state(jcfg, B, CACHE),
        jnp.asarray(LENS))
    tl, tst = TT.prefill(tp, torch.from_numpy(toks), tcfg,
                         TT.init_decode_state(tcfg, B, CACHE),
                         lengths=torch.from_numpy(LENS))
    _close(tl, jl)
    step = jax.jit(lambda p, t, s, c: JT.decode_step(p, t, s, c, jcfg))
    tok, pos = np.argmax(np.asarray(jl), -1).astype(np.int32), LENS.copy()
    for i in range(STEPS[arch]):
        jl, jst = step(jp, jnp.asarray(tok), jst, jnp.asarray(pos))
        if i % 20 == 0 or i == STEPS[arch] - 1:
            st = TT.tree_map(lambda a: a.clone(), tst)
            ttok, _ = TT.decode_step(tp, torch.from_numpy(tok), st,
                                     torch.from_numpy(pos), tcfg,
                                     return_tokens=True)
        tl, tst = TT.decode_step(tp, torch.from_numpy(tok), tst,
                                 torch.from_numpy(pos), tcfg)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        if i % 20 == 0 or i == STEPS[arch] - 1:
            assert np.array_equal(ttok.numpy(), tok)
        pos = pos + 1
    assert tst["k"].shape[2] == (WINDOW if arch == MIXTRAL else CACHE)
    assert (pos.max() > WINDOW) == (arch == MIXTRAL)
    for k in ("k", "v"):
        _close(tst[k], jst[k], floor=1.0)


def test_decode_rows_route_alone(models):
    """At decode x is [B, 1, d]: each row is a group of one token with
    capacity 1, so nothing drops, and a dead slot (a row of garbage)
    beside a live one leaves the live row's routes and output as they are
    alone. The layer of the reduced phi3.5-moe, with a router that sends
    every token to expert 0, where one group of both rows would drop."""
    _, tcfg, _, tp = models(PHI)
    p = TT.layer_slice(tp["layers"], 0)["mlp"]
    d, E = tcfg.d_model, tcfg.n_experts
    w = torch.zeros(d, E)
    w[:, 0] = 1.0
    p = dict(p, router={"w": w})
    rng = np.random.default_rng(5)
    live = torch.from_numpy(3.0 + rng.normal(0, 1, (1, 1, d)).astype(
        np.float32))
    dead = torch.from_numpy(rng.normal(0, 30, (3, 1, d)).astype(np.float32))
    x = torch.cat([live, dead, live + 0.5], dim=0)          # [5, 1, d]
    _, _, idx, slot, keep = TM.route(p["router"]["w"], x, 2, 1)
    assert bool(keep.all()) and not bool(slot.any())
    assert bool(torch.all(idx[[0, 4], 0, 0] == 0))
    _, _, idx1, _, _ = TM.route(p["router"]["w"], live, 2, 1)
    assert torch.equal(idx1[0], idx[0])
    y, _ = TM.moe_apply(p, x, k=2)
    # other garbage in the dead slots: the live rows' bits stay
    other = torch.cat([live, -dead.flip(0) * 2.0, live + 0.5], dim=0)
    y2, _ = TM.moe_apply(p, other, k=2)
    assert torch.equal(y2[[0, 4]], y[[0, 4]])
    # alone (other product shapes: f32 sums in other orders)
    alone, _ = TM.moe_apply(p, live, k=2)
    np.testing.assert_allclose(y[0].numpy(), alone[0].numpy(), rtol=0,
                               atol=1e-5 * float(alone.abs().max()))
    # the same two live tokens in one group of capacity int(1.25 * 2 * 2 /
    # 4) = 1 drop the second token's expert-0 choice
    both, _ = TM.moe_apply(p, torch.cat([live, live + 0.5], dim=1), k=2)
    assert not torch.allclose(both[0, 1], y[4, 0])


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


@pytest.mark.parametrize("arch", ARCHS)
def test_split_mixed_steps_match_jax(arch, models):
    """``split_prefill_mixed`` then ``split_decode_step_mixed`` ticks with
    the modes rolling over the rows: on a paged arena (phi3.5-moe) or the
    dense rolling state (mixtral, past its window): logits, the state and
    the fused tail's tokens."""
    jcfg, tcfg, jp, tp = models(arch)
    toks = _tokens(jcfg, seed=2)
    steps = STEPS[arch]
    modes = np.array([0, 1, 1], np.int32)
    if arch == PHI:
        bt, n_pages = _tables(LENS, steps)
        jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)
        jst0 = JT.init_decode_state(jcfg, n_pages + 1, PAGE)
        tst0 = TT.init_decode_state(tcfg, n_pages + 1, PAGE)
    else:
        jbt = tbt = None
        jst0 = JT.init_decode_state(jcfg, B, CACHE)
        tst0 = TT.init_decode_state(tcfg, B, CACHE)
    jstack = JB.bank_stack(jp["bneck_modes"], jcfg.split)
    tstack = TB.bank_stack(tp["bneck_modes"], tcfg.split)
    jl, jst = jax.jit(lambda p, k, t, s, m, n, b: JSP.split_prefill_mixed(
        p, k, t, s, jcfg, m, lengths=n, block_table=b))(
            jp, jstack, jnp.asarray(toks), jst0, jnp.asarray(modes),
            jnp.asarray(LENS), jbt)
    jstep = jax.jit(lambda p, k, t, s, c, m, b: JSP.split_decode_step_mixed(
        p, k, t, s, c, jcfg, m, block_table=b))
    tl, tst = TSP.split_prefill_mixed(
        tp, tstack, torch.from_numpy(toks), tst0, tcfg,
        torch.from_numpy(modes), lengths=torch.from_numpy(LENS),
        block_table=tbt)
    _close(tl, jl)
    tok, pos = np.array(jnp.argmax(jl, -1), np.int32), LENS.copy()
    for step in range(steps):
        m = np.roll(modes, step)
        jl, jst = jstep(jp, jstack, jnp.asarray(tok), jst, jnp.asarray(pos),
                        jnp.asarray(m), jbt)
        args = (tp, tstack, torch.from_numpy(tok), tst,
                torch.from_numpy(pos), tcfg, torch.from_numpy(m), tbt)
        check_tail = step % 20 == 0 or step == steps - 1
        if check_tail:     # first: it writes the same K/V rows again
            tt, _ = TSP.split_decode_step_mixed(*args, return_tokens=True)
        tl, tst = TSP.split_decode_step_mixed(*args)
        _close(tl, jl)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        if check_tail:
            np.testing.assert_array_equal(tt.numpy(), tok)
        pos = pos + 1
    for k in ("k", "v"):
        _close(tst[k], jst[k], floor=1.0)


def _requests(cfg, fleet, chan_cfg, request_cls, long_gen: bool):
    """Six requests on mixed channels; ``long_gen``: each generates 58-63
    tokens, so every one decodes past the reduced mixtral's window."""
    chans = fleet(N_REQ, chan_cfg(mean_mbps=0.5, std_mbps=0.4,
                                  blockage_prob=0.08, recovery_prob=0.15),
                  seed=11, mean_spread=0.95)
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(N_REQ):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(5, 9))).astype(np.int32)
        gen = int(rng.integers(58, 64) if long_gen else rng.integers(2, 8))
        reqs.append(request_cls(rid=i, prompt=prompt, max_new_tokens=gen,
                                channel=chans[i], arrival_tick=i // 2))
    return reqs


def _continuous(eng_cls, cfg, params, bn, fleet, chan_cfg, request_cls,
                profile, req, orch):
    orch = orch([profile(m, bn.mode_payload_bytes(cfg, 1, 1, m), float(m))
                 for m in range(cfg.split.n_modes)],
                req(latency_budget_s=0.006), ema=0.5, hysteresis=1.0)
    windowed = not JT.full_attention_arch(cfg)
    kw = ({"cache_len": CACHE} if windowed
          else {"cache_len": 32, "page_len": 8, "n_pages": 5})
    eng = eng_cls(params, cfg, orchestrator=orch, n_slots=3, **kw)
    done = eng.run(_requests(cfg, fleet, chan_cfg, request_cls, windowed))
    st = eng.stats()
    per = {s.request.rid: (list(s.tokens), [tuple(t) for t in s.mode_trace],
                           s.wire_bytes, s.admitted_tick, s.finished_tick)
           for s in done}
    keys = ("paged", "decode_ticks", "mixed_mode_ticks", "wire_bytes",
            "prefill_calls", "mode_counts", "requests_finished")
    return per, {k: st[k] for k in keys}


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_jax(arch, models):
    """The continuous engine of both packages on the same requests:
    phi3.5-moe on the paged pool (five pages: requests park), mixtral on
    the dense rolling pool (``cache_len`` 96, capped at its window: 64
    rows a slot; every request decodes past position 64, so the window
    slides). Per-request tokens, mode traces, wire bytes and lifecycle,
    and the engine's counters."""
    jcfg, tcfg, jp, tp = models(arch)
    want = _continuous(JEngine, jcfg, jp, JB, j_fleet, JChannelConfig,
                       JRequest, JProfile, JReq, JOrch)
    got = _continuous(TEngine, tcfg, tp, TB, t_fleet, TChannelConfig,
                      TRequest, TProfile, TReq, TOrch)
    assert got == want
    assert got[1]["paged"] == (arch == PHI)
    assert len(got[1]["mode_counts"]) > 1
    assert got[1]["requests_finished"] == N_REQ
    if arch == MIXTRAL:
        eng_rows = TEngine(tp, tcfg, n_slots=1, cache_len=CACHE)
        assert eng_rows.pool.states["k"].shape[2] == WINDOW
        assert all(len(t[0]) > WINDOW - 8 for t in got[0].values())


def test_sync_engine_matches_jax(models):
    """``ServingEngine.prefill`` + ``decode_tokens`` under an orchestrator
    fed a link that drops and recovers, on both archs (mixtral decodes 60
    tokens, past its window): the same tokens, wire bytes and mode counts,
    at least two modes used."""
    for arch in ARCHS:
        jcfg, tcfg, jp, tp = models(arch)
        toks = _tokens(jcfg, seed=4)
        budget = tx_seconds(1.5 * TB.mode_payload_bytes(tcfg, B, 1, 0), 1e8)
        outs = []
        for eng_cls, cfg, params, mod in ((JSyncEngine, jcfg, jp, jserve),
                                          (TSyncEngine, tcfg, tp, tserve)):
            orch = mod.build_orchestrator(cfg, B, budget)
            eng = eng_cls(params, cfg, cache_len=CACHE, batch=B,
                          orchestrator=orch)
            first = np.argmax(np.asarray(eng.prefill(toks)), -1).astype(
                np.int32)
            caps = itertools.cycle([1e8] * 2 + [1e3] * 4 + [1e8] * 4)
            gen = eng.decode_tokens(first, STEPS[arch] + 5,
                                    capacity_bps_fn=lambda: next(caps))
            outs.append((np.asarray(gen).tolist(), eng.stats.wire_bytes,
                         dict(eng.stats.mode_counts)))
        assert outs[1] == outs[0], arch
        assert len(outs[1][2]) >= 2


def _batch(cfg, seed=0):
    return jtokens.MarkovTokenSource(cfg, seed=seed).batch(2, 16, 0)


def _moved_codes(jcfg, tcfg, jp, tp, tokens, mode) -> int:
    """The wire codes of ``mode`` that differ between the packages on the
    same tokens (0 for the unquantized modes); each by at most one step,
    on at most ``EDGE_LANES`` of the lanes."""
    if not mode:
        return 0
    jpay, _, _ = JSP.encoder_apply(jp, jnp.asarray(tokens), jcfg, mode)
    tpay, _, _ = TSP.encoder_apply(tp, torch.from_numpy(tokens), tcfg, mode)
    want = np.asarray(jpay[0]).astype(np.int32)
    diff = np.abs(tpay[0].numpy().astype(np.int32) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= EDGE_LANES
    return int((diff > 0).sum())


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS
                                       for m in (None, 0, 1)])
def test_first_train_step_matches_jax(arch, mode, models):
    """The first step of ``make_train_step``: the loss (with AUX_WEIGHT
    times the summed aux), its lm and aux parts, the gradient norm, every
    leaf's gradient and every updated leaf. A leaf outside the graph (the
    bank in modes None and 0) has no gradient, as the reference's
    zeros. Where a wire code moved at a rounding edge, the flip rule of
    the module docstring."""
    jcfg, tcfg, jp, tp = models(arch)
    batch = _batch(jcfg)
    moved = _moved_codes(jcfg, tcfg, jp, tp, batch["tokens"], mode)
    loss_rel = FLIP_LOSS_REL if moved else LOSS_REL
    grad_rel = FLIP_GRAD_REL if moved else GRAD_REL
    small_g = FLIP_GRAD_REL if moved else SMALL_G
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (_, _), jg = jax.jit(jax.value_and_grad(
        JL.make_loss_fn(jcfg, mode=mode), has_aux=True))(jp, jb)
    jp2, js2, jm = jax.jit(JL.make_train_step(jcfg, JTrainConfig(**TCFG),
                                              mode=mode))(jp, JO.init(jp), jb)
    tp = TT.tree_map(lambda a: a.clone(), tp)      # the step donates
    loss_t = TL.make_loss_fn(tcfg, mode=mode)
    (_, _), tg = TC.value_and_grad(lambda p, b, _: loss_t(p, b), tp, tb,
                                   mode)
    tp2, ts2, tm = TL.make_train_step(tcfg, TrainConfig(**TCFG),
                                      mode=mode)(tp, TO.init(tp), tb)
    assert sorted(tm) == sorted(jm)
    assert int(ts2.step) == int(js2.step) == 1
    assert float(tm["aux_loss"]) > 0
    for k in ("loss", "lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=loss_rel, atol=LOSS_ABS)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=grad_rel)
    lr = float(jm["lr"])
    g_want, g_got = jckpt._flatten(jg), flat_from_params(tg)
    p0, want = jckpt._flatten(jp), jckpt._flatten(jp2)
    got = flat_from_params(tp2)
    assert sorted(got) == sorted(want)
    outside = set(g_want) - set(g_got)
    assert all(not np.any(g_want[k]) for k in outside)
    assert (mode == 1) == (not outside)
    assert np.any(g_got["layers/mlp/router/w"])
    top = max(float(np.abs(g).max()) for g in g_want.values())
    for k in want:
        g = np.asarray(g_want[k])
        big = max(float(np.abs(g).max()), GRAD_FLOOR * top)
        gk = g_got.get(k, np.zeros_like(g))
        assert np.all(np.abs(gk - g) <= grad_rel * big), (k, "gradient")
        small = np.abs(g) < small_g * big
        bound = np.where(small, 2 * lr, STEP_REL * (
            np.abs(p0[k]) + np.abs(p0[k] - want[k])))
        assert np.all(np.abs(got[k] - want[k]) <= bound), (k, "update")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


MOE_LEAVES = ("layers/mlp/router/w", "layers/mlp/w_gate", "layers/mlp/w_up",
              "layers/mlp/w_down")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_weights_cross_both_ways(arch, tmp_path):
    """The bf16 MoE tree: ``params_from_flat`` / ``flat_from_params``
    round-trip it bit for bit, and a checkpoint written by either package
    restores in the other bit for bit."""
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = JSP.init_split_params(jax.random.PRNGKey(3), jcfg)
    flat = jckpt._flatten(jp)
    tp = params_from_flat(flat, device="cpu")
    L, d, f, E = tcfg.n_layers, tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    shapes = dict(zip(MOE_LEAVES, ((L, d, E), (L, E, d, f), (L, E, d, f),
                                   (L, E, f, d))))
    got = flat_tensors(tp)
    for k, shape in shapes.items():
        assert tuple(got[k].shape) == shape
        assert got[k].dtype == (torch.float32 if "router" in k
                                else torch.bfloat16)
    back = flat_from_params(tp)
    assert sorted(back) == sorted(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(a, np.float32))
    own = TSP.init_split_params(torch.Generator().manual_seed(1), tcfg)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t.npz")
    jckpt.save(jpath, jp, {"arch": arch})
    tckpt.save(tpath, own, {"arch": arch})
    restored = flat_tensors(tckpt.restore(jpath + ".npz", own))
    assert sorted(restored) == sorted(flat)
    for k, t in restored.items():
        np.testing.assert_array_equal(_bits(t), _jbits(flat[k]))
    jback = jckpt._flatten(jckpt.restore(tpath, jp))
    for k, t in flat_tensors(own).items():
        np.testing.assert_array_equal(_jbits(jback[k]), _bits(t))


def test_cascade_checkpoint_serves(tmp_path):
    """``launch.train --cascade --reduced`` on phi3.5-moe: finite losses,
    both phases timed; its checkpoint restores bit for bit (in the
    reference's tree too), and ``launch.serve --ckpt`` decodes from it the
    tokens the saved weights give in memory."""
    saved = {}
    orig = tckpt.save

    def keep(path, tree, metadata=None):
        saved["tree"] = TT.tree_map(lambda a: a.clone(), tree)
        orig(path, tree, metadata)

    tckpt.save = keep
    try:
        hist = ttrain.main(["--arch", PHI, "--reduced", "--steps", "3",
                            "--batch", "2", "--seq", "16", "--ckpt-dir",
                            str(tmp_path), "--cascade", "--device", "cpu"])
    finally:
        tckpt.save = orig
    assert set(hist["ms_per_step"]) == {"phase1", "phase2"}
    logged = [r["loss"] for p in hist["phases"] for r in p["log"]]
    assert logged and all(np.isfinite(logged))
    path = str(tmp_path / "phi3_5-moe-42b-a6_6b.npz")
    cfg = t_reduced(PHI)
    fresh = TSP.init_split_params(torch.Generator().manual_seed(9), cfg)
    restored = flat_tensors(tckpt.restore(path, fresh))
    want = flat_tensors(saved["tree"])
    assert sorted(restored) == sorted(want)
    for k, t in restored.items():
        np.testing.assert_array_equal(_bits(t), _bits(want[k]))
    back = jckpt._flatten(jckpt.restore(path, JSP.init_split_params(
        jax.random.PRNGKey(0), j_reduced(PHI))))
    assert sorted(back) == sorted(want)

    argv = ["--arch", PHI, "--reduced", "--device", "cpu", "--requests",
            "2", "--prompt-len", "4", "--gen", "6", "--cache-len", "32",
            "--policy", "static1"]
    from_ckpt = tserve.main(argv + ["--ckpt", path])
    in_memory = tserve.run_sync(tserve.parser().parse_args(argv), cfg,
                                saved["tree"])
    untrained = tserve.main(argv)
    assert from_ckpt["generated"] == in_memory["generated"]
    assert from_ckpt["generated"] != untrained["generated"]
