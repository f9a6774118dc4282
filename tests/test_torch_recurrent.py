"""The port's recurrent slice against the JAX package: the RG-LRU scan,
the RG-LRU block, rolling-cache (windowed) attention, reduced
recurrentgemma-2b split prefill and mixed-mode decode on the dense state,
the tied decode tail, and the conversion of a heterogeneous parameter tree.

Inputs are made from numpy seeds; weights come from the JAX package's
initialisers and cross over through ``repro_torch.convert``.

The scan: XLA on the CPU contracts the reference's ``a * h + b`` into one
fused multiply-add (its output equals a float64-emulated FMA step for
step), while the port rounds the product and the sum separately (two
eager ops on the CPU, ``__fmul_rn`` / ``__fadd_rn`` in the CUDA kernel,
which the card holds bit for bit against the plain version). The two
differ by at most one rounding of ``a * h`` a step, carried forward with a
factor |a| <= 1, so they agree within ``S * 2**-23 * max|h|``.
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
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import attention as JA
from repro.models import rglru as JRG
from repro.models import transformer as JT
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import load_npz, params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core import split as TSP
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.models import attention as TA
from repro_torch.models import rglru as TRG
from repro_torch.models import transformer as TT

ARCH = "recurrentgemma-2b"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaf(tree, key):
    node = tree
    for part in key.split("/"):
        node = node[int(part)] if isinstance(node, tuple) else node[part]
    return node


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

def _scan_inputs(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 1.0, (B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, h0


def _scan_tol(S, h):
    return S * 2.0 ** -23 * float(np.abs(h).max())


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_scan_ref_matches_jax(with_h0):
    """Against the JAX oracle and the Pallas kernel in interpret mode (S a
    multiple of 8, D of 128), within the FMA bound of the module doc."""
    B, S, D = 3, 16, 256
    a, b, h0 = _scan_inputs(B, S, D)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    got = TREF.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                              th0).numpy()
    oracle = np.asarray(JREF.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                            jh0))
    pallas = np.asarray(JOPS.rglru_scan_op(jnp.asarray(a), jnp.asarray(b),
                                           jh0, interpret=True))
    tol = _scan_tol(S, oracle)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)
    # the port's dispatcher on the CPU is its plain version, bit for bit
    np.testing.assert_array_equal(
        TOPS.rglru_scan_op(torch.from_numpy(a), torch.from_numpy(b),
                           th0).numpy(), got)


def test_rglru_scan_ref_two_roundings_per_step():
    """The plain version rounds the product before the add at every step
    (what the CUDA kernel computes): equal, bit for bit, to a numpy loop of
    two float32 ops, at an odd S and D the TPU kernel does not take."""
    B, S, D = 2, 13, 37
    a, b, h0 = _scan_inputs(B, S, D, seed=1)
    h = h0.copy()
    want = np.empty_like(a)
    for t in range(S):
        h = (a[:, t] * h).astype(np.float32) + b[:, t]
        want[:, t] = h
    got = TREF.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(h0)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

def _close(dt, got, want, what):
    """float32: 1e-5 (sums in two orders); bfloat16: two ulps of the
    output's scale (the two frameworks round GeLU and the bf16 matmuls
    at different places)."""
    g, w = _f(got), _f(want)
    if dt == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=what)
    else:
        atol = 2.0 ** -7 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=atol,
                                   err_msg=what)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rglru_prefill_then_steps_match_jax(dt):
    jdt, tdt = DT[dt]
    B, S, d, dr = 3, 16, 64, 128
    jp = JRG.rglru_init(jax.random.PRNGKey(0), d, dr, dtype=jdt)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    lens = np.array([16, 5, 9], np.int32)
    jst = JRG.rglru_state_init(B, dr, dtype=jdt)
    tst = TRG.rglru_state_init(B, dr, dtype=tdt)
    assert tst["conv"].dtype == tdt and tst["h"].dtype == torch.float32
    jy, jst = JRG.rglru_prefill(jp, jnp.asarray(x).astype(jdt), jst,
                                lengths=jnp.asarray(lens))
    ty = TRG.rglru_prefill(tp, torch.from_numpy(x).to(tdt), tst,
                           lengths=torch.from_numpy(lens))
    _close(dt, ty, jy, "prefill y")
    np.testing.assert_allclose(_f(tst["h"]), _f(jst["h"]), rtol=1e-5,
                               atol=1e-5)
    # the history rows are the same rounded inputs: equal
    np.testing.assert_array_equal(_f(tst["conv"]), _f(jst["conv"]))
    for step in range(3):
        x1 = rng.standard_normal((B, 1, d)).astype(np.float32)
        jy, jst = JRG.rglru_step(jp, jnp.asarray(x1).astype(jdt), jst)
        ty = TRG.rglru_step(tp, torch.from_numpy(x1).to(tdt), tst)
        _close(dt, ty, jy, f"step {step} y")
        np.testing.assert_allclose(_f(tst["h"]), _f(jst["h"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(_f(tst["conv"]), _f(jst["conv"]))


# ---------------------------------------------------------------------------
# windowed attention on the rolling cache
# ---------------------------------------------------------------------------

def test_windowed_prefill_and_decode_wrap_match_jax():
    """A prompt longer than the window, then decode steps past
    ``cache_len``: the rolling writes wrap."""
    B, S, d, nq, nkv, hd, window = 3, 24, 64, 4, 1, 16, 8
    jp = JA.attn_init(jax.random.PRNGKey(3), d, nq, nkv, hd,
                      dtype=jnp.float32)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    lens = np.array([24, 5, 11], np.int32)
    dims = dict(n_q=nq, n_kv=nkv, hd=hd, rope_theta=10_000.0, window=window)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jc = JA.init_cache(B, nkv, hd, window, dtype=jnp.float32)
    tc = TA.init_cache(B, nkv, hd, window, dtype=torch.float32)
    jy, jc = JA.prefill_attention(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                                  lengths=jnp.asarray(lens), **dims)
    ty = TA.prefill_attention(tp, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), tc,
                              lengths=torch.from_numpy(lens), **dims)
    valid = np.arange(S)[None, :] < lens[:, None]
    np.testing.assert_allclose(_f(ty)[valid], _f(jy)[valid], rtol=1e-5,
                               atol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(_f(tc[k]), _f(jc[k]), rtol=1e-5,
                                   atol=1e-5)
    cur = lens.copy()
    for step in range(7):          # row 1 passes cache_len and wraps
        x1 = rng.standard_normal((B, 1, d)).astype(np.float32)
        jy, jc = JA.decode_attention(jp, jnp.asarray(x1), jc,
                                     jnp.asarray(cur), **dims)
        ty = TA.decode_attention(tp, torch.from_numpy(x1), tc,
                                 torch.from_numpy(cur), **dims)
        np.testing.assert_allclose(_f(ty), _f(jy), rtol=1e-5, atol=1e-5,
                                   err_msg=f"step {step}")
        cur = cur + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(_f(tc[k]), _f(jc[k]), rtol=1e-5,
                                   atol=1e-5)


def test_windowed_blocked_attention_matches_dense():
    """The blocked online-softmax path (long prompts) applies the same
    window as the dense path."""
    B, S, nq, nkv, hd = 1, 1024, 2, 1, 8
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, S, nq, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, nkv, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, nkv, hd)).astype(
        np.float32))
    pos = torch.arange(S, dtype=torch.int32)[None]
    dense = TA._dense_attention(q, k, v, pos, hd, 300)
    blocked = TA._blocked_attention(q, k, v, pos, hd, 300)
    torch.testing.assert_close(blocked, dense, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# reduced recurrentgemma-2b: split prefill + mixed-mode decode, dense state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_reduced(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(ARCH), dtype="float32")
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _clone(states):
    return TT.tree_map(lambda a: a.clone(), states)


def _states_close(tst, jst):
    assert len(tst) == len(jst)
    for i, (t, j) in enumerate(zip(tst, jst)):
        assert set(t) == set(j), i
        for k in j:
            assert str(t[k].dtype) == "torch." + str(j[k].dtype), (i, k)
            np.testing.assert_allclose(_f(t[k]), _f(j[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"layer {i} {k}")


def test_split_prefill_then_mixed_decode_dense_match(models):
    jcfg, tcfg, jp, tp = models
    assert not tcfg.homogeneous and tcfg.tie_embeddings
    lens = np.array([40, 5, 17], np.int32)     # 40 > local_window 32
    B, S = len(lens), 64
    clen = tcfg.local_window
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    modes = np.array([0, 1, 1], np.int32)
    jstack = JB.bank_stack(jp["bneck_modes"], jcfg.split)
    tstack = TB.bank_stack(tp["bneck_modes"], tcfg.split)
    jst = JT.init_decode_state(jcfg, B, clen)
    tst = TT.init_decode_state(tcfg, B, clen)
    jl, jst = JSP.split_prefill_mixed(
        jp, jstack, jnp.asarray(toks), jst, jcfg, jnp.asarray(modes),
        lengths=jnp.asarray(lens))
    tl, tst = TSP.split_prefill_mixed(
        tp, tstack, torch.from_numpy(toks), tst, tcfg,
        torch.from_numpy(modes), lengths=torch.from_numpy(lens))
    assert tl.shape == (B, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_f(tl), _f(jl), rtol=1e-4, atol=1e-4)
    _states_close(tst, jst)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok)

    pos = lens.copy()
    for step in range(6):          # row 0 (past the window) wraps
        m = np.roll(modes, step)
        jl, jst = JSP.split_decode_step_mixed(
            jp, jstack, jnp.asarray(tok), jst, jnp.asarray(pos), jcfg,
            jnp.asarray(m))
        args = (tp, tstack, torch.from_numpy(tok))
        rest = (torch.from_numpy(pos), tcfg, torch.from_numpy(m))
        # the fused tail on a copy: a recurrent step must not run twice
        tt, _ = TSP.split_decode_step_mixed(*args, _clone(tst), *rest,
                                            return_tokens=True)
        tl, tst = TSP.split_decode_step_mixed(*args, tst, *rest)
        np.testing.assert_allclose(_f(tl), _f(jl), rtol=1e-4, atol=1e-4)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok)
        np.testing.assert_array_equal(tt.numpy(), tok)
        pos = pos + 1
    _states_close(tst, jst)


# ---------------------------------------------------------------------------
# the tied decode tail
# ---------------------------------------------------------------------------

def test_tied_decode_tail_ref_matches_jax():
    rng = np.random.default_rng(6)
    V, d, B = 300, 64, 5
    table = rng.standard_normal((V, d)).astype(np.float32)
    x = rng.standard_normal((B, 2, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    top = np.asarray(JREF.decode_tail_ref(
        jnp.asarray(x), jnp.asarray(scale), None, jnp.asarray(table)[None],
        tied=True))
    # an exact tie: row 0's winner copied to a lower and a higher index
    w = int(top[0, 0])
    low = 3 if w > 3 else w
    table[low] = table[w]
    table[(w + V // 2) % V] = table[w]
    want = np.asarray(JREF.decode_tail_ref(
        jnp.asarray(x), jnp.asarray(scale), None, jnp.asarray(table)[None],
        tied=True))
    got = TOPS.decode_tail_op(torch.from_numpy(x), torch.from_numpy(scale),
                              None, torch.from_numpy(table)[None], tied=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, 0]) == low
    # the grouped plain version reads the [V, d] table in place
    from repro_torch.kernels.boundary_mixed import decode_tail_grouped
    dest, hid_g, P = TOPS.head_layout(torch.zeros(B * 2, dtype=torch.int32),
                                      1, 8)
    xp = torch.zeros((P, d))
    xp[dest] = torch.from_numpy(x).reshape(B * 2, d)
    tok = decode_tail_grouped(xp, torch.from_numpy(table)[None],
                              torch.from_numpy(scale), torch.zeros(d), hid_g,
                              block_r=8, tied=True)
    np.testing.assert_array_equal(tok[dest].reshape(B, 2).numpy(), want)


# ---------------------------------------------------------------------------
# conversion of a heterogeneous tree
# ---------------------------------------------------------------------------

def test_heterogeneous_params_convert_exactly(models, tmp_path):
    """Tuple-of-layers trees and the f32 ``lam`` leaves cross bit for bit,
    in memory and through a bf16 checkpoint ``.npz``."""
    _, tcfg, jp, tp = models
    assert isinstance(tp["layers"], tuple)
    assert len(tp["layers"]) == tcfg.n_layers
    for k, v in checkpoint._flatten(jp).items():
        np.testing.assert_array_equal(_leaf(tp, k).numpy(), v)
    jbf = JSP.init_split_params(jax.random.PRNGKey(1), j_reduced(ARCH))
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, jbf)
    tbf = load_npz(path, device="cpu")
    assert tbf["layers"][0]["mix"]["in_gate"]["w"].dtype == torch.bfloat16
    assert tbf["layers"][0]["mix"]["lam"].dtype == torch.float32
    assert set(tbf["layers"][2]["mix"]) == {"wq", "wk", "wv", "wo"}
    for k, v in checkpoint._flatten(jbf).items():
        np.testing.assert_array_equal(_leaf(tbf, k).float().numpy(),
                                      np.asarray(v, np.float32))
