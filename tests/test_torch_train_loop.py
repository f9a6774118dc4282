"""The port's transformer training loop (``repro_torch.training.loop``)
against the JAX package's ``make_train_step`` called without a mesh, on
the CPU, and the two forms each step must give the same bits in: the
donated AdamW update (``apply_updates(donate=True)``) and the per-layer
recomputation of ``T.run_layers`` (``scan_utils.remat``).

Reduced configs in float32, weights from the JAX init carried across by
``repro_torch.convert``, the batch from ``MarkovTokenSource``. Tolerances
of the first step, as ``tests/test_torch_cascade.py`` states them for a
composed step: the loss within 1e-5 + 1e-6 of its value (a few f32 ulp:
recurrentgemma-2b's random tied head gives losses near 127); each leaf's
gradient within 1e-4 of its scale, the largest |g| of the leaf but at
least 1e-3 of the largest |g| of any leaf (a leaf whose gradient cancels
to rounding level, as the mLSTM's input gate does at the first step,
where the stabiliser makes i_g = 1 whatever i_pre, is held to the
rounding of the terms that cancel); each updated element within 1e-5 of
|p| + |delta|, except where |g| < 1e-3 of that scale, where Adam's first
update (about lr * sign(g)) may flip and move the element by up to 2 lr.
A leaf outside the loss's graph (the bank in modes None and 0) has the
gradient None, which counts as the reference's zeros.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import split as JSP
from repro.data import tokens
from repro.training import checkpoint
from repro.training import loop as JL
from repro.training import optimizer as JO
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import flat_from_params, params_from_flat
from repro_torch.core import cascade as TC
from repro_torch.core import split as TSP
from repro_torch.training import loop as TL
from repro_torch.training import optimizer as TO

LOSS_ABS = 1e-5
LOSS_REL = 1e-6
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-3
STEP_REL = 1e-5
SMALL_G = 1e-3
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=100)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its steps are many
    small ops, which stall when several test processes' thread teams share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0):
    jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
    jp = JSP.init_split_params(jax.random.PRNGKey(seed), jcfg)
    batch = tokens.MarkovTokenSource(jcfg, seed=seed).batch(2, 16, 0)
    return jcfg, tcfg, jp, batch


def _torch(jp, batch):
    return (params_from_flat(checkpoint._flatten(jp), device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch,mode", [("qwen2.5-3b", None),
                                       ("qwen2.5-3b", 0), ("qwen2.5-3b", 1),
                                       ("recurrentgemma-2b", None),
                                       ("xlstm-125m", None)])
def test_first_train_step_matches_reference(arch, mode):
    jcfg, tcfg, jp, batch = _setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j = JL.make_loss_fn(jcfg, mode=mode)
    (_, _), jg = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(jp, jb)
    jp2, js2, jm = jax.jit(JL.make_train_step(jcfg, JTrainConfig(**TCFG),
                                              mode=mode))(jp, JO.init(jp), jb)
    tp, tb = _torch(jp, batch)
    loss_t = TL.make_loss_fn(tcfg, mode=mode)
    (_, _), tg = TC.value_and_grad(lambda p, b, _: loss_t(p, b), tp, tb,
                                   mode)
    tp2, ts2, tm = TL.make_train_step(tcfg, TrainConfig(**TCFG),
                                      mode=mode)(tp, TO.init(tp), tb)
    assert sorted(tm) == sorted(jm)
    assert int(ts2.step) == int(js2.step) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_REL, atol=LOSS_ABS)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=GRAD_REL)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    lr = float(jm["lr"])
    g_want, g_got = checkpoint._flatten(jg), flat_from_params(tg)
    p0, want = checkpoint._flatten(jp), checkpoint._flatten(jp2)
    got = flat_from_params(tp2)
    assert sorted(got) == sorted(want)
    outside = set(g_want) - set(g_got)
    assert all(not np.any(g_want[k]) for k in outside)
    assert (mode == 1) == (not outside)
    top = max(float(np.abs(g).max()) for g in g_want.values())
    for k in want:
        g = np.asarray(g_want[k])
        big = max(float(np.abs(g).max()), GRAD_FLOOR * top)
        gk = g_got.get(k, np.zeros_like(g))
        assert np.all(np.abs(gk - g) <= GRAD_REL * big), (k, "gradient")
        small = np.abs(g) < SMALL_G * big
        bound = np.where(small, 2 * lr, STEP_REL * (
            np.abs(p0[k]) + np.abs(p0[k] - want[k])))
        assert np.all(np.abs(got[k] - want[k]) <= bound), (k, "update")


def _same(a, b):
    fa, fb = flat_from_params(a), flat_from_params(b)
    return sorted(fa) == sorted(fb) and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("arch,mode", [("qwen2.5-3b", 1),
                                       ("recurrentgemma-2b", None)])
def test_donated_step_keeps_bits(arch, mode, monkeypatch):
    """Two steps with ``donate=True`` update the trees passed in and give
    the bits of ``donate=False``: parameters, m, v, step and metrics; bf16
    parameters as the model runs them. Blocks of 997 elements, so most
    leaves are updated in several row blocks (one row where a row is
    larger)."""
    monkeypatch.setattr(TO, "_DONATE_BLOCK", 997)
    tcfg = t_reduced(arch)
    p = TSP.init_split_params(torch.Generator().manual_seed(0), tcfg)
    tb = {k: torch.from_numpy(v) for k, v in tokens.MarkovTokenSource(
        tcfg, seed=0).batch(2, 16, 0).items()}
    tcf = TrainConfig(**TCFG)
    out = {}
    for donate in (False, True):
        params = TO.unflatten(p, [t.clone() for t in TO.leaves(p)])
        state = TO.init(params)
        step = TL.make_train_step(tcfg, tcf, mode=mode, donate=donate)
        given = (params, state)
        ms = []
        for _ in range(2):
            params, state, m = step(params, state, tb)
            ms.append(m)
        if donate:
            assert params is given[0] and state.m is given[1].m
            assert all(a is b for a, b in zip(TO.leaves(params),
                                              TO.leaves(given[0])))
        out[donate] = (params, state, ms)
    (p0, s0, m0), (p1, s1, m1) = out[False], out[True]
    assert _same(p0, p1) and _same(s0.m, s1.m) and _same(s0.v, s1.v)
    assert int(s0.step) == int(s1.step) == 2
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)


def test_masked_donated_step_keeps_frozen_leaves():
    """Algorithm 1's phase 2 with ``donate=True``: the frozen leaves, their
    m and v are not written; the bank's head is, as ``donate=False``
    writes it."""
    _, _, jp, batch = _setup("qwen2.5-3b")
    tcfg = dataclasses.replace(t_reduced("qwen2.5-3b"), dtype="float32")
    p, tb = _torch(jp, batch)
    loss = TL.make_loss_fn(tcfg, mode=1)
    res = {}
    for donate in (False, True):
        params = TO.unflatten(p, [t.clone() for t in TO.leaves(p)])
        before = [t.clone() for t in TO.leaves(params)]
        state = TO.init(params)
        mask = TC.transformer_phase_mask(params, 2)
        step = TC.make_train_step(lambda q, b, _: loss(q, b),
                                  TrainConfig(**TCFG), donate=donate)
        params, state, _ = step(params, state, tb, mask, mode=1)
        for t, a, b, m in zip(TO.leaves(mask), before, TO.leaves(params),
                              TO.leaves(state.m)):
            assert torch.equal(a, b) != t
            assert bool(m.any()) == t
        res[donate] = params
    assert _same(res[False], res[True])


def test_layer_recompute_keeps_bits(monkeypatch):
    """``train=True`` recomputes each layer (and each kv or scan chunk) in
    the backward; with recomputation off (``checkpoint`` replaced by a
    plain call) the loss and every gradient are the same bits."""
    _, tcfg, jp, batch = _setup("qwen2.5-3b")
    tp, tb = _torch(jp, batch)
    loss = TL.make_loss_fn(tcfg, mode=1)
    calls = []
    orig = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    (l_on, _), g_on = TC.value_and_grad(lambda p, b, _: loss(p, b), tp, tb, 1)
    assert len(calls) == tcfg.n_layers
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    (l_off, _), g_off = TC.value_and_grad(lambda p, b, _: loss(p, b), tp, tb,
                                          1)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(a, b) for a, b in zip(TO.leaves(g_on),
                                                 TO.leaves(g_off)))


def test_eval_step_and_train_loop():
    """``make_eval_step`` runs without autograd and agrees with the loss
    function; ``train_loop`` logs finite losses on the reference's
    schedule and times every step when asked."""
    _, tcfg, jp, batch = _setup("qwen2.5-3b")
    tp, tb = _torch(jp, batch)
    ev = TL.make_eval_step(tcfg, mode=0)(tp, tb)
    assert not ev["loss"].requires_grad
    want, _ = TL.make_loss_fn(tcfg, mode=0)(tp, tb)
    assert torch.equal(ev["loss"], want.detach())
    src = tokens.MarkovTokenSource(tcfg, seed=0)
    times = {}
    _, hist = TL.train_loop(tp, tcfg, TrainConfig(**TCFG),
                            lambda s: src.batch(2, 16, s), steps=5,
                            log_every=2, step_times=times)
    assert [h["step"] for h in hist] == [0, 2, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert len(times[None]) == 5


def test_mesh_and_pipeline_raise():
    """The pod pipeline needs a mesh with a pod axis: ``ValueError``
    without a mesh and on a (data, model) mesh."""
    cfg = t_reduced("qwen2.5-3b")
    with pytest.raises(ValueError, match="'pod' axis"):
        TL.make_loss_fn(cfg, use_pipeline=True)
    flat = types.SimpleNamespace(shape={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="'pod' axis"):
        TL.make_train_step(cfg, TrainConfig(), use_pipeline=True, mesh=flat)
