"""The port's synchronous split-serving path against the JAX package's, on
reduced float32 qwen2.5-3b (dense GQA, full attention),
recurrentgemma-2b (RG-LRU and local attention, tied head) and xlstm-125m
(mLSTM and sLSTM, layernorm, untied head), with weights
converted from JAX's ``init_split_params`` and three extra bottleneck
modes (bits 4, 1 and 0 besides the config's 8), so every wire format is
crossed: ``T.prefill`` / ``T.decode_step``, ``split_decode_step`` /
``split_prefill`` for every mode, the ``ServingEngine`` under an
orchestrator, ``launch.serve --engine sync`` against the JAX ``run_sync``,
and a CPU smoke of the kernel bench.

Logits are held to ``LOGIT_RTOL`` times the largest logit: f32 sums in
other orders through a few layers (and, on recurrentgemma-2b, the JAX
CPU scan's fused multiply-add, see ``tests/test_torch_recurrent.py``);
measured at about 6e-7 (qwen2.5-3b) and 2.5e-7 (recurrentgemma-2b).
Tokens, wire bytes and mode counts must be equal.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.serving import ServingEngine as JEngine
from repro.training import checkpoint
from repro_torch.benchmarks import bench_kernels
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import split as TSP
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serving import ServingEngine as TEngine

ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m")
EXTRA_MODES = ((16, 4), (24, 1), (8, 0))
LOGIT_RTOL = 2e-6
B, S, CACHE = 2, 8, 32
LENS = np.array([8, 5], np.int32)


def _cfg(get, arch, extra=EXTRA_MODES):
    cfg = dataclasses.replace(get(arch), dtype="float32")
    return dataclasses.replace(cfg, split=dataclasses.replace(
        cfg.split, extra_modes=extra))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, tcfg = _cfg(j_reduced, arch), _cfg(t_reduced, arch)
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    toks = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tp, toks


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


def _sorted_leaves(tree):
    """Tensor leaves in the JAX tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _sorted_leaves(v)]
    return [tree]


def _states_close(tst, jst):
    jleaves = jax.tree_util.tree_leaves(jst)
    tleaves = _sorted_leaves(tst)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=LOGIT_RTOL * max(np.abs(j).max(), 1))


def test_prefill_and_decode_step_match_jax(setup):
    """``T.prefill`` over ragged rows, then two ``T.decode_step`` calls from
    its state: logits, the filled states, and the fused tail's tokens."""
    jcfg, tcfg, jp, tp, toks = setup
    jl, jst = JT.prefill(jp, jnp.asarray(toks), jcfg,
                         JT.init_decode_state(jcfg, B, CACHE),
                         lengths=jnp.asarray(LENS))
    tl, tst = TT.prefill(tp, torch.from_numpy(toks), tcfg,
                         TT.init_decode_state(tcfg, B, CACHE),
                         lengths=torch.from_numpy(LENS))
    _close(tl, jl)
    _states_close(tst, jst)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    pos = LENS.copy()
    for _ in range(2):
        jl, jst = JT.decode_step(jp, jnp.asarray(tok), jst,
                                 jnp.asarray(pos), jcfg)
        st = TT.tree_map(lambda a: a.clone(), tst)
        ttok, _ = TT.decode_step(tp, torch.from_numpy(tok), st,
                                 torch.from_numpy(pos), tcfg,
                                 return_tokens=True)
        tl, tst = TT.decode_step(tp, torch.from_numpy(tok), tst,
                                 torch.from_numpy(pos), tcfg)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        assert ttok.dtype == torch.int32 and np.array_equal(ttok.numpy(), tok)
        pos = pos + 1
    _states_close(tst, jst)


def test_split_decode_step_every_mode_matches_jax(setup):
    """One aligned split decode step (an int position, as the sync engine
    gives) from a prefilled state, in every mode: logits, payload bytes
    and the fused tail's tokens."""
    jcfg, tcfg, jp, tp, toks = setup
    _, jst = JT.prefill(jp, jnp.asarray(toks), jcfg,
                        JT.init_decode_state(jcfg, B, CACHE))
    tl0, tst = TT.prefill(tp, torch.from_numpy(toks), tcfg,
                          TT.init_decode_state(tcfg, B, CACHE))
    tok = torch.argmax(tl0, -1).to(torch.int32)
    for m in range(jcfg.split.n_modes):
        jl, _, jpb = JSP.split_decode_step(jp, jnp.asarray(tok.numpy()), jst,
                                           jnp.int32(S), jcfg, mode=m)
        st = TT.tree_map(lambda a: a.clone(), tst)
        tl, _, tpb = TSP.split_decode_step(tp, tok, st, S, tcfg, mode=m)
        _close(tl, jl)
        assert tpb == jpb
        st = TT.tree_map(lambda a: a.clone(), tst)
        ttok, _, _ = TSP.split_decode_step(tp, tok, st, S, tcfg, mode=m,
                                           return_tokens=True)
        assert ttok.shape == (B, 1)
        assert np.array_equal(ttok.numpy(),
                              np.argmax(np.asarray(jl), -1))


def test_split_prefill_every_mode_matches_jax(setup):
    """``split_prefill`` over ragged rows in every mode against the JAX
    ``split_prefill`` on the same inputs (not against a decode loop: the
    reference's own prefill-vs-loop test fails in mode 4): logits, the
    filled states and the payload bytes."""
    jcfg, tcfg, jp, tp, toks = setup
    for m in range(jcfg.split.n_modes):
        jl, jst, jpb = JSP.split_prefill(
            jp, jnp.asarray(toks), jcfg, JT.init_decode_state(jcfg, B, CACHE),
            mode=m, lengths=jnp.asarray(LENS))
        tl, tst, tpb = TSP.split_prefill(
            tp, torch.from_numpy(toks), tcfg,
            TT.init_decode_state(tcfg, B, CACHE), mode=m,
            lengths=torch.from_numpy(LENS))
        _close(tl, jl)
        _states_close(tst, jst)
        assert tpb == jpb


def _capacities():
    """A link (bytes/s) that drops below mode 0's rate and recovers, so the
    orchestrator leaves mode 0 and comes back."""
    caps = iter([1e8] * 2 + [1e3] * 6 + [1e8] * 20)
    return lambda: next(caps)


def test_sync_engine_matches_jax(setup):
    """``ServingEngine.prefill`` + ``decode_tokens`` under an orchestrator
    fed the same capacities: the same tokens, wire bytes and mode counts,
    with at least two modes used; a continuation prefill from ``pos > 0``
    takes the per-token path and matches too."""
    jcfg, tcfg, jp, tp, toks = setup
    outs = []
    for eng_cls, cfg, params, mod in ((JEngine, jcfg, jp, jserve),
                                      (TEngine, tcfg, tp, tserve)):
        orch = mod.build_orchestrator(cfg, B, 4.01e-3)
        eng = eng_cls(params, cfg, cache_len=CACHE, batch=B,
                      orchestrator=orch)
        logits = eng.prefill(toks)
        first = np.argmax(np.asarray(logits), -1).astype(np.int32)
        gen = eng.decode_tokens(first, 12, capacity_bps_fn=_capacities())
        more = eng.prefill(toks[:, :2])
        outs.append((np.asarray(gen), eng.stats.wire_bytes,
                     dict(eng.stats.mode_counts), eng.pos,
                     np.asarray(more)))
    (jg, jw, jm, jpos, jmore), (tg, tw, tm, tpos, tmore) = outs
    assert np.array_equal(tg, jg) and tg.dtype == np.int32
    assert (tw, tm, tpos) == (jw, jm, jpos)
    assert len(tm) >= 2
    np.testing.assert_allclose(tmore, jmore, rtol=0,
                               atol=LOGIT_RTOL * np.abs(jmore).max())


def _serve_args(policy, **kw):
    ns = dict(arch="qwen2.5-3b", requests=3, prompt_len=6, gen=8,
              cache_len=32, policy=policy, latency_budget_ms=4.005,
              channel_seed=1, dp=None, mp=None, profile_dir=None)
    ns.update(kw)
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("policy", ["static1", "orchestrator"])
def test_serve_sync_matches_jax_run_sync(policy):
    """``launch.serve``'s ``run_sync`` on the CPU against the JAX
    ``run_sync`` on the same weights and channel: tokens, wire bytes, mode
    counts and switches."""
    jcfg = _cfg(j_reduced, "qwen2.5-3b", ())
    tcfg = _cfg(t_reduced, "qwen2.5-3b", ())
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    want = jserve.run_sync(_serve_args(policy), jcfg, jp)
    got = tserve.run_sync(_serve_args(policy), tcfg, tp)
    for k in ("tokens", "wire_bytes", "mode_counts", "mode_switches",
              "wire_bytes_per_token"):
        assert got.get(k) == want.get(k), k
    assert np.asarray(got["generated"]).shape == (3, 8)
    assert got["engine"] == "sync" and got["device"] == "cpu"


def test_serve_main_defaults_to_sync_and_refuses_mesh():
    """``--engine`` defaults to sync (as in the reference); the generated
    tokens come back in the summary; a serving mesh needs ranks this
    process does not have (``telemetry=`` is ported: the same tokens,
    with the reference's histograms)."""
    argv = ["--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
            "--requests", "2", "--gen", "4", "--policy", "static0"]
    out = tserve.main(argv)
    assert out["engine"] == "sync" and out["mode_counts"] == {0: 4}
    assert len(out["generated"]) == 2 and len(out["generated"][0]) == 4
    traced = tserve.main(argv + ["--telemetry"])
    assert traced["generated"] == out["generated"]
    assert traced["latency"]["engine_sync.prefill_s"]["count"] == 1
    cfg = _cfg(t_reduced, "qwen2.5-3b", ())
    params = TSP.init_split_params(torch.Generator().manual_seed(0), cfg)
    from repro_torch.models import sharding
    with pytest.raises(ValueError, match="ranks"):
        TEngine(params, cfg, mesh=sharding.serving_mesh(2))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        TEngine(params, cfg, cache_len=4).prefill(np.ones((1, 5), np.int32))


def test_bench_kernels_cpu_smoke(tmp_path):
    """The kernel bench on the CPU (the plain versions) at its own shapes:
    both parity checks hold, every timing is positive, and the JSON lands."""
    path = tmp_path / "kernels.json"
    out = bench_kernels.main(["--device", "cpu", "--json", str(path)])
    assert out["boundary_mixed_parity_ok"] and out["mega_parity_ok"]
    assert out["device"] == "cpu" and path.exists()
    assert all(out[k] > 0 for k in out if k.endswith("_us"))
    assert out["wire_compression"] == pytest.approx((512 + 2) / (2 * 2048))
