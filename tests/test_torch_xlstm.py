"""The port's xLSTM blocks and its completed RG-LRU block against the JAX
package: ``chunked_scan``, the mLSTM (prefill with lengths, decode steps,
the full-sequence pass), the sLSTM, ``slstm_prepare``, ``rglru_full`` and
the RG-LRU cell route, the two mLSTM routes bit for bit within the port,
the conversion of xLSTM's parameter tree, and the -inf stabiliser through
the dense slot pool.

Inputs are made from numpy seeds; weights come from the JAX package's
initialisers and cross over through ``repro_torch.convert``.

Tolerances: float32 outputs within 1e-5 (sums in two orders); bfloat16
within two ulps of the output's scale (``_close``). The mLSTM normalizer
n, which the scan op carries, within ``S · 2^-23 · max|n|``: XLA on the
CPU contracts ``f_g * n + i_g * k`` into one fused multiply-add, the port
rounds the product and the sum (see ``tests/test_torch_recurrent.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.models import rglru as JRG
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import load_npz, params_from_flat
from repro_torch.core import split as TSP
from repro_torch.models import rglru as TRG
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.models.scan_utils import chunked_scan
from repro_torch.serving.batcher import SlotPool

ARCH = "xlstm-125m"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, D, H = 3, 12, 64, 4
LENS = np.array([12, 5, 9], np.int32)


def _f(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(dt, got, want, what):
    """float32: 1e-5 (sums in two orders); bfloat16: two ulps of the
    output's scale (the two frameworks round the bf16 matmuls and the
    activations at different places)."""
    g, w = _f(got), _f(want)
    if dt == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=what)
    else:
        atol = 2.0 ** -7 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=atol,
                                   err_msg=what)


def _states_close(dt, tst, jst, steps, what):
    """Carried state: n within the scan bound over ``steps`` steps, the
    other leaves as ``_close`` (a -inf stabiliser must stay -inf)."""
    assert set(tst) == set(jst)
    for k in jst:
        assert tst[k].dtype == torch.float32, k
        if k == "n" and "C" in jst:
            w = _f(jst[k])
            tol = steps * 2.0 ** -23 * float(np.abs(w).max())
            np.testing.assert_allclose(_f(tst[k]), w, rtol=0, atol=tol,
                                       err_msg=f"{what} n")
        else:
            _close("float32" if dt == "float32" else "bfloat16", tst[k],
                   jst[k], f"{what} {k}")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dt):
    jdt, tdt = DT[dt]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _params(init, seed, dt, *args):
    jp = init(jax.random.PRNGKey(seed), *args, dtype=DT[dt][0])
    return jp, params_from_flat(checkpoint._flatten(jp), device="cpu")


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(TT.tree_leaves(a),
                                                 TT.tree_leaves(b)))


# ---------------------------------------------------------------------------
# chunked_scan
# ---------------------------------------------------------------------------

def test_chunked_scan_matches_a_plain_loop():
    """Tree state and tree outputs over the leading time dimension, bit for
    bit a Python loop of the cell, whatever ``chunk`` says."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1, (7, 2, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((7, 2, 5)).astype(np.float32))

    def cell(st, t):
        at, bt = t
        h = at * st["h"] + bt
        return {"h": h, "n": st["n"] + 1}, (h, {"sq": h * h})

    st0 = {"h": torch.zeros(2, 5), "n": torch.zeros(())}
    for chunk in (256, 2):
        final, (hs, extra) = chunked_scan(cell, st0, (a, b), chunk=chunk)
        st, want = st0, []
        for t in range(7):
            st, (h, _) = cell(st, (a[t], b[t]))
            want.append(h)
        assert hs.shape == (7, 2, 5) and extra["sq"].shape == (7, 2, 5)
        assert torch.equal(hs, torch.stack(want))
        assert torch.equal(extra["sq"], hs * hs)
        assert torch.equal(final["h"], st["h"]) and int(final["n"]) == 7


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mlstm_prefill_then_steps_match_jax(dt):
    """A ragged prefill through the scan op, then three decode steps from
    the state it left: outputs and C, n, m."""
    jp, tp = _params(JX.mlstm_init, 0, dt, D, H)
    jx, tx = _both(_x((B, S, D), 1), dt)
    jst = JX.mlstm_state_init(B, D, H)
    tst = TX.mlstm_state_init(B, D, H)
    assert bool(torch.isneginf(tst["m"]).all())
    jy, jst = JX.mlstm_prefill(jp, jx, jst, H, lengths=jnp.asarray(LENS))
    ty = TX.mlstm_prefill(tp, tx, tst, H, lengths=torch.from_numpy(LENS))
    _close(dt, ty, jy, "prefill y")
    _states_close(dt, tst, jst, S, "prefill")
    for step in range(3):
        jx1, tx1 = _both(_x((B, 1, D), 10 + step), dt)
        jy, jst = JX.mlstm_step(jp, jx1, jst, H)
        ty = TX.mlstm_step(tp, tx1, tst, H)
        _close(dt, ty, jy, f"step {step} y")
        _states_close(dt, tst, jst, S + step + 1, f"step {step}")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["scan_op", "cell"])
def test_mlstm_full_matches_jax(dt, train):
    jp, tp = _params(JX.mlstm_init, 2, dt, D, H)
    jx, tx = _both(_x((B, S, D), 3), dt)
    _close(dt, TX.mlstm_full(tp, tx, H, train=train),
           JX.mlstm_full(jp, jx, H, train=train), "mlstm_full")


def test_mlstm_scan_op_and_cell_routes_are_bit_identical():
    """The port's two routes: ``mlstm_prefill`` outputs and final C, n, m
    for full and ragged lengths, chained from a real mid-stream state
    (finite m, non-zero C and n), and ``mlstm_full`` eval against train."""
    H4, d = 4, 64
    jp, tp = _params(JX.mlstm_init, 10, "bfloat16", d, H4)
    x = torch.from_numpy(_x((3, 11, d), 11)).to(torch.bfloat16)
    st = TX.mlstm_state_init(3, d, H4)
    for lengths in (None, torch.tensor([11, 5, 2], dtype=torch.int32)):
        outs = []
        for use_scan_op in (False, True):
            s = _clone(st)
            y = TX.mlstm_prefill(tp, x, s, H4, lengths=lengths,
                                 use_scan_op=use_scan_op)
            outs.append((y, s))
        (y0, s0), (y1, s1) = outs
        assert torch.equal(y0, y1) and _equal_trees(s0, s1)
    mid = outs[0][1]
    assert bool(torch.isfinite(mid["m"]).all()) and bool(mid["C"].abs().max())
    lengths = torch.tensor([4, 11, 8], dtype=torch.int32)
    outs = []
    for use_scan_op in (False, True):
        s = _clone(mid)
        y = TX.mlstm_prefill(tp, x, s, H4, lengths=lengths,
                             use_scan_op=use_scan_op)
        outs.append((y, s))
    (y0, s0), (y1, s1) = outs
    assert torch.equal(y0, y1) and _equal_trees(s0, s1)
    xf = torch.from_numpy(_x((3, 19, d), 9)).to(torch.bfloat16)
    assert torch.equal(TX.mlstm_full(tp, xf, H4, train=True),
                       TX.mlstm_full(tp, xf, H4, train=False))


def test_mlstm_stabilizer_no_overflow():
    """Large preactivations keep the output finite (the m stabiliser)."""
    _, tp = _params(JX.mlstm_init, 0, "float32", 8, 2)
    x = 100.0 * torch.from_numpy(_x((1, 16, 8), 4))
    assert bool(torch.isfinite(TX.mlstm_full(tp, x, 2)).all())


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_slstm_prefill_steps_and_full_match_jax(dt):
    jp, tp = _params(JX.slstm_init, 5, dt, D, H)
    jx, tx = _both(_x((B, S, D), 6), dt)
    _close(dt, TX.slstm_full(tp, tx, H), JX.slstm_full(jp, jx, H),
           "slstm_full")
    jst = JX.slstm_state_init(B, D)
    tst = TX.slstm_state_init(B, D)
    assert bool(torch.isneginf(tst["m"]).all())
    jy, jst = JX.slstm_prefill(jp, jx, jst, H, lengths=jnp.asarray(LENS))
    ty = TX.slstm_prefill(tp, tx, tst, H, lengths=torch.from_numpy(LENS))
    _close(dt, ty, jy, "prefill y")
    _states_close(dt, tst, jst, S, "prefill")
    for step in range(3):
        jx1, tx1 = _both(_x((B, 1, D), 20 + step), dt)
        jy, jst = JX.slstm_step(jp, jx1, jst, H)
        ty = TX.slstm_step(tp, tx1, tst, H)
        _close(dt, ty, jy, f"step {step} y")
        _states_close(dt, tst, jst, S + step + 1, f"step {step}")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_slstm_prepare_gives_the_same_bits(dt):
    """``slstm_prepare`` makes the f32 forms once: a prepared prefill and
    three steps equal the unprepared ones bit for bit; an f32 model's forms
    alias its weights; preparing twice is a no-op."""
    _, tp = _params(JX.slstm_init, 7, dt, D, H)
    prep = TX.slstm_prepare(tp)
    assert TX.slstm_prepare(prep) is prep and "f32" not in tp
    assert prep["f32"]["r_i"].dtype == torch.float32
    assert prep["f32"]["w_f"]["b"].dtype == torch.float32
    if dt == "float32":
        assert prep["f32"]["w_z"]["w"] is tp["w_z"]["w"]
    x = torch.from_numpy(_x((B, S + 3, D), 8)).to(DT[dt][1])
    st = {k: TX.slstm_state_init(B, D) for k in ("raw", "prep")}
    ys = [TX.slstm_prefill(p, x[:, :S], st[k], H, lengths=torch.from_numpy(
        LENS)) for k, p in (("raw", tp), ("prep", prep))]
    assert torch.equal(*ys) and _equal_trees(st["raw"], st["prep"])
    for t in range(S, S + 3):
        ys = [TX.slstm_step(p, x[:, t:t + 1], st[k], H)
              for k, p in (("raw", tp), ("prep", prep))]
        assert torch.equal(*ys) and _equal_trees(st["raw"], st["prep"])


# ---------------------------------------------------------------------------
# the RG-LRU block, completed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rglru_full_and_cell_route_match_jax(dt):
    """``rglru_full`` eval (scan op) and train (cell scan) against JAX and
    bit-identical to each other; ``rglru_prefill(use_scan_op=False)``
    against JAX's, and bit-identical to the scan-op route, outputs and
    carried state, from a non-zero carry with ragged lengths."""
    d, dr = 64, 96
    jp, tp = _params(JRG.rglru_init, 4, dt, d, dr)
    jx, tx = _both(_x((B, 17, d), 5), dt)
    y_op = TRG.rglru_full(tp, tx)
    y_cell = TRG.rglru_full(tp, tx, train=True)
    assert torch.equal(y_op, y_cell)
    _close(dt, y_op, JRG.rglru_full(jp, jx), "rglru_full")
    _close(dt, y_cell, JRG.rglru_full(jp, jx, train=True), "rglru_full train")
    h0 = _x((B, dr), 6)
    conv = _x((B, 3, dr), 7)
    jst = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv).astype(DT[dt][0])}
    lens = np.array([17, 7, 1], np.int32)
    jy, jst = JRG.rglru_prefill(jp, jx, jst, lengths=jnp.asarray(lens),
                                use_scan_op=False)
    outs = []
    for use_scan_op in (False, True):
        st = {"h": torch.from_numpy(h0.copy()),
              "conv": torch.from_numpy(conv.copy()).to(DT[dt][1])}
        y = TRG.rglru_prefill(tp, tx, st, lengths=torch.from_numpy(lens),
                              use_scan_op=use_scan_op)
        outs.append((y, st))
    (y0, s0), (y1, s1) = outs
    assert torch.equal(y0, y1) and _equal_trees(s0, s1)
    _close(dt, y0, jy, "rglru_prefill cell route")
    np.testing.assert_allclose(_f(s0["h"]), _f(jst["h"]), rtol=1e-5,
                               atol=1e-5)
    _close(dt, s0["conv"], jst["conv"], "conv history")


# ---------------------------------------------------------------------------
# the reduced model: conversion, prefill and decode, the slot pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_reduced(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(ARCH), dtype="float32")
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _leaf(tree, key):
    node = tree
    for part in key.split("/"):
        node = node[int(part)] if isinstance(node, tuple) else node[part]
    return node


def test_xlstm_params_convert_exactly(model, tmp_path):
    """xLSTM's tuple of per-layer trees, with the bare ``[H, hd, hd]``
    ``r_*`` leaves and the layernorm biases, crosses bit for bit, in memory
    and through a bf16 checkpoint ``.npz``; the port's own init makes the
    same tree."""
    jcfg, tcfg, jp, tp = model
    assert isinstance(tp["layers"], tuple) and len(tp["layers"]) == 2
    for k, v in checkpoint._flatten(jp).items():
        np.testing.assert_array_equal(_leaf(tp, k).numpy(), v)
    jbf = JSP.init_split_params(jax.random.PRNGKey(1), j_reduced(ARCH))
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, jbf)
    tbf = load_npz(path, device="cpu")
    hd = jcfg.d_model // jcfg.n_heads
    r = tbf["layers"][1]["mix"]["r_o"]
    assert r.dtype == torch.bfloat16 and r.shape == (jcfg.n_heads, hd, hd)
    assert "bias" in tbf["final_norm"]
    for k, v in checkpoint._flatten(jbf).items():
        np.testing.assert_array_equal(_leaf(tbf, k).float().numpy(),
                                      np.asarray(v, np.float32))
    mine = TSP.init_split_params(torch.Generator().manual_seed(0), tcfg)
    assert sorted(checkpoint._flatten(jp)) == sorted(_paths(mine))
    for k in checkpoint._flatten(jp):
        assert _leaf(mine, k).shape == _leaf(tp, k).shape, k


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def test_xlstm_prefill_then_decode_match_jax(model):
    """``T.prefill`` over ragged rows then two ``T.decode_step`` calls on
    the reduced f32 model: logits and every layer's state."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jst = JT.prefill(jp, jnp.asarray(toks), jcfg,
                         JT.init_decode_state(jcfg, B, 16),
                         lengths=jnp.asarray(LENS))
    tl, tst = TT.prefill(tp, torch.from_numpy(toks), tcfg,
                         TT.init_decode_state(tcfg, B, 16),
                         lengths=torch.from_numpy(LENS))
    _close("float32", tl, jl, "prefill logits")
    for i, (t, j) in enumerate(zip(tst, jst)):
        _states_close("float32", t, j, S, f"layer {i}")
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    assert np.array_equal(torch.argmax(tl, -1).numpy(), tok)
    pos = LENS.copy()
    for step in range(2):
        jl, jst = JT.decode_step(jp, jnp.asarray(tok), jst, jnp.asarray(pos),
                                 jcfg)
        tl, tst = TT.decode_step(tp, torch.from_numpy(tok), tst,
                                 torch.from_numpy(pos), tcfg)
        _close("float32", tl, jl, f"step {step} logits")
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        assert np.array_equal(torch.argmax(tl, -1).numpy(), tok)
        pos = pos + 1
    for i, (t, j) in enumerate(zip(tst, jst)):
        _states_close("float32", t, j, S + 2, f"layer {i}")


def test_slot_pool_keeps_the_minus_inf_stabiliser(model):
    """A fresh slot's m is -inf, never 0: the pool starts so, and a fresh
    batched state scattered into slots (as the engine's admission does)
    keeps it, beside a prefilled row's finite m."""
    _, tcfg, _, tp = model
    pool = SlotPool(tcfg, 4, 16)
    for st in pool.states:
        assert bool(torch.isneginf(st["m"]).all())
    fresh = TT.init_decode_state(tcfg, 2, 16)
    TT.prefill(tp, torch.ones((1, 5), dtype=torch.int32), tcfg,
               tuple({k: v[:1] for k, v in st.items()} for st in fresh))
    pool.write_rows(fresh, [2, 0], [5, 1])
    for st in pool.states:
        assert bool(torch.isfinite(st["m"][2]).all())
        assert bool(torch.isneginf(st["m"][[0, 1, 3]]).all())
        assert not bool(st["n"][0].abs().max())
