"""The port's full-sequence forward against the JAX package's, on the CPU:
``T.forward`` in eval and train, ``full_attention`` on its dense and
blocked routes, ``rglru_full(use_assoc_scan=True)``, ``lm_loss``, and the
recomputation (``scan_utils.remat``) that training runs, which must give
the bits of the plain backward.

Weights come from the JAX package's init at reduced shapes in float32 and
cross over through ``repro_torch.convert``; tokens and activations are made
from a seed with numpy. Tolerances: the forward logits within 1e-4 of
JAX's (values O(1); f32 GEMM sums in two orders through a few layers, and
XLA contracts the scan's a * h + b into an FMA where the port rounds twice,
``tests/test_torch_recurrent.py``); attention outputs within 1e-5 (two
orders of f32 sums and exps); the associative scan within 1e-5 of the
step-by-step scan (another summation tree over |h| < 3); the loss within
1e-6. Recompute on and off: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.models import attention as JA
from repro.models import rglru as JR
from repro.models import transformer as JT
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.models import attention as TA
from repro_torch.models import rglru as TR
from repro_torch.models import scan_utils
from repro_torch.models import transformer as TT

ARCHS = ["qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m"]
LOGITS_ABS = 1e-4


def _f32(arch):
    return (dataclasses.replace(j_reduced(arch), dtype="float32"),
            dataclasses.replace(t_reduced(arch), dtype="float32"))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _f32(arch)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, tcfg, jp,
                     params_from_flat(checkpoint._flatten(jp), device="cpu"))
    return out


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch, train):
    """Logits and the aux loss of a [2, 16] batch; the eval forward of the
    recurrent archs reaches the scan op's plain version in both packages,
    the train forward the cell scans."""
    jcfg, tcfg, jp, tp = models[arch]
    tok = _tokens(jcfg, 2, 16)
    want, jaux = JT.forward(jp, jnp.asarray(tok), jcfg, train=train)
    with torch.no_grad():
        got, aux = TT.forward(tp, torch.from_numpy(tok), tcfg, train=train)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_ABS)
    assert float(aux) == float(jaux) == 0.0


def test_forward_bf16_recurrent_eval_equals_train():
    """recurrentgemma-2b in its own bf16: the eval forward (the scan op's
    plain version) and the train forward (the cell scan) give the same
    bits, as the CUDA scan must give the cell scan's on the card."""
    cfg = t_reduced("recurrentgemma-2b")
    p = TT.init_params(torch.Generator().manual_seed(0), cfg)
    tok = torch.from_numpy(_tokens(cfg, 2, 24, seed=3))
    with torch.no_grad():
        a, _ = TT.forward(p, tok, cfg, train=False)
        b, _ = TT.forward(p, tok, cfg, train=True)
    assert torch.equal(a, b)


def _attn(hd=16, n_q=4, n_kv=2, d=64, seed=1):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0, shape[0] ** -0.5, shape).astype(np.float32)

    flat = {"wq/w": w(d, n_q * hd), "wk/w": w(d, n_kv * hd),
            "wv/w": w(d, n_kv * hd), "wo/w": w(n_q * hd, d),
            "wq/b": w(n_q * hd) * 0.1, "wk/b": w(n_kv * hd) * 0.1,
            "wv/b": w(n_kv * hd) * 0.1}
    jp = {"wq": {"w": flat["wq/w"], "b": flat["wq/b"]},
          "wk": {"w": flat["wk/w"], "b": flat["wk/b"]},
          "wv": {"w": flat["wv/w"], "b": flat["wv/b"]},
          "wo": {"w": flat["wo/w"]}}
    return jax.tree.map(jnp.asarray, jp), params_from_flat(flat,
                                                           device="cpu")


@pytest.mark.parametrize("S,window", [(64, 0), (64, 24), (2048, 0),
                                      (2048, 700)])
def test_full_attention_matches_reference(S, window):
    """Dense below ``BLOCKED_ATTN_THRESHOLD``, blocked at S 2048; causal
    and windowed."""
    jp, tp = _attn()
    x = np.random.default_rng(2).normal(0, 1, (1, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (1, S))
    kw = dict(n_q=4, n_kv=2, hd=16, rope_theta=10_000.0, window=window)
    want = JA.full_attention(jp, jnp.asarray(x), jnp.asarray(pos), **kw)
    with torch.no_grad():
        got = TA.full_attention(tp, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def _no_remat(monkeypatch):
    """Recomputation off: ``remat`` runs the function as it is."""
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))


def _grads(fn, inputs):
    ins = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    g = torch.autograd.grad(out.square().sum(), ins)
    return out.detach(), g


def test_blocked_attention_recompute_keeps_bits(monkeypatch):
    """Under autograd each kv step of the blocked route is recomputed in
    the backward; output and gradients equal the plain backward's bits."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (1, 2048, n, 8))
                                .astype(np.float32)) for n in (4, 2, 2))
    pos = torch.arange(2048, dtype=torch.int32)[None]

    def f(q, k, v):
        return TA._blocked_attention(q, k, v, pos, 8, 0, 1024, 1024)

    on = _grads(f, (q, k, v))
    _no_remat(monkeypatch)
    off = _grads(f, (q, k, v))
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


def test_chunked_scan_recompute_keeps_bits(monkeypatch):
    """A 32-step scan in chunks of 8 under autograd: states, outputs and
    gradients equal those of the plain loop (chunk >= T)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 1, (32, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (32, 3, 4)).astype(np.float32))

    def cell(h, ab):
        h = ab[0] * h + ab[1]
        return h, torch.tanh(h)

    def run(chunk):
        def f(a, b):
            h, ys = scan_utils.chunked_scan(cell, torch.zeros(3, 4), (a, b),
                                            chunk=chunk)
            return ys * h
        return _grads(f, (a, b))

    calls = []
    orig = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    chunked, plain = run(8), run(32)
    assert len(calls) == 4
    assert torch.equal(chunked[0], plain[0])
    assert all(torch.equal(x, y) for x, y in zip(chunked[1], plain[1]))


def test_rglru_assoc_scan_matches_reference():
    """``use_assoc_scan=True`` against the reference's associative scan and
    the port's step-by-step scan on one RG-LRU block, S 37 (not a power of
    two)."""
    jcfg, tcfg = _f32("recurrentgemma-2b")
    d, dr = jcfg.d_model, jcfg.d_rnn
    jp = JR.rglru_init(jax.random.PRNGKey(2), d, dr, dtype=jnp.float32)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    x = np.random.default_rng(6).normal(0, 1, (2, 37, d)).astype(np.float32)
    want = JR.rglru_full(jp, jnp.asarray(x), use_assoc_scan=True)
    with torch.no_grad():
        got = TR.rglru_full(tp, torch.from_numpy(x), use_assoc_scan=True)
        seq = TR.rglru_full(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0, atol=1e-5)


def test_lm_loss_matches_reference():
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 3, (2, 5, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = JT.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                          None if m is None else jnp.asarray(m))
        got = TT.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=1e-6)


def test_run_layers_unbinds_stacked_leaves_once():
    """A train forward's backward through the stacked leaves: one
    ``unbind`` a leaf (a single ``stack`` backward), no per-layer index."""
    _, tcfg = _f32("qwen2.5-3b")
    p = TT.init_params(torch.Generator().manual_seed(1), tcfg)
    tok = torch.from_numpy(_tokens(tcfg, 1, 8))
    w = p["layers"]["mlp"]["w_up"]["w"].requires_grad_(True)
    logits, _ = TT.forward(p, tok, tcfg, train=True)
    names, todo, seen = [], [logits.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    assert "UnbindBackward0" in names and "SelectBackward0" not in names
    (g,) = torch.autograd.grad(logits.square().mean(), w)
    assert g.shape == w.shape and torch.isfinite(g).all()
