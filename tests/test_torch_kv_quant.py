"""The int8 rolling KV cache in the port (``init_decode_state(kv_bits=8)``:
int8 codes and one float32 scale per position and head).

Mirrors ``tests/test_kv_quant.py`` on the port (stablelm-3b and
mixtral-8x7b) and adds recurrentgemma-2b, where only the local-attention
layers take int8: decoding from the int8 cache tracks the exact decode on
the reduced bf16 configs, with that test's bounds (the quantized attention
state under 0.75x the bytes, the greatest relative logit error under 0.05,
or 0.25 for MoE, whose routing int8 noise can flip; greedy agreement at
least 90%).

Against the reference's int8 path (reduced f32, weights converted from
JAX): after a ragged prefill and after each of three decode steps, every
layer's codes and scales. A code may differ by one step only where z /
scale sits on a rounding edge, which the two sides' f32 sums (other
orders) may straddle: at most ``EDGE_LANES`` of the lanes, none by more
than one step; scales within ``SCALE_RTOL``; logits within ``LOGIT_RTOL``
of their largest magnitude while every code is equal, and within
``FLIP_RTOL`` once a code has moved (one step moves one K or V element by
its row's scale, 1/127 of the row's absmax: 1.7e-4 of the largest logit
seen on stablelm-3b).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.models import transformer as JT
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import split as TSP
from repro_torch.models import transformer as TT

ARCHS = ("stablelm-3b", "recurrentgemma-2b")
# the reference's int8 decode cases: its dense and MoE archs
DECODE_ARCHS = ("stablelm-3b", "mixtral-8x7b", "recurrentgemma-2b")
EDGE_LANES = 1e-3
SCALE_RTOL = 1e-5
LOGIT_RTOL = 1e-5
FLIP_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced shapes: one intra-op thread is enough, and the test workers
    beside this one keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _attention_states(cfg, states):
    """The attention layers' states: all of them (stacked) or those of
    the attention blocks of a heterogeneous stack."""
    if cfg.homogeneous:
        return [states]
    return [st for i, st in enumerate(states) if cfg.block_kind(i) == "attn"]


def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in TT.tree_leaves(tree))


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_kv8_decode_tracks_exact(arch):
    cfg = t_reduced(arch)
    params = TSP.init_split_params(torch.Generator().manual_seed(0), cfg)
    B, steps, cache = 2, 10, 32
    st_f = TT.init_decode_state(cfg, B, cache)
    st_q = TT.init_decode_state(cfg, B, cache, kv_bits=8)
    att_f, att_q = _attention_states(cfg, st_f), _attention_states(cfg, st_q)
    assert att_q and all(set(a) == {"k", "k_s", "v", "v_s"} for a in att_q)
    assert all(a["k"].dtype == torch.int8 and a["k_s"].dtype == torch.float32
               and a["k_s"].shape[-1] == 1 for a in att_q)
    # the quantized state must actually be smaller (int8 codes + scales)
    assert _nbytes(att_q) < 0.75 * _nbytes(att_f)
    if not cfg.homogeneous:        # the recurrent layers keep their state
        for i, (a, b) in enumerate(zip(st_f, st_q)):
            if cfg.block_kind(i) != "attn":
                assert [(t.dtype, t.shape) for t in TT.tree_leaves(a)] == \
                    [(t.dtype, t.shape) for t in TT.tree_leaves(b)]
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)).astype(
        np.int32))
    maxdiff, agree = 0.0, 0
    for i in range(steps):
        lf, st_f = TT.decode_step(params, tok, st_f, i, cfg)
        lq, st_q = TT.decode_step(params, tok, st_q, i, cfg)
        rel = float(torch.linalg.vector_norm(lf - lq)
                    / max(float(torch.linalg.vector_norm(lf)), 1e-9))
        maxdiff = max(maxdiff, rel)
        agree += int((lf.argmax(-1) == lq.argmax(-1)).sum())
        tok = lf.argmax(-1).to(torch.int32).reshape(tok.shape)
    # MoE routing is discontinuous: int8 noise can flip an expert choice
    # on untrained weights, so greedy agreement is the invariant there
    assert maxdiff < (0.25 if cfg.is_moe else 0.05), maxdiff
    assert agree >= 0.9 * steps * B          # greedy tokens agree


def _hold_cache(got, want, where) -> int:
    """Codes and scales of the int8 attention layers against the
    reference's. Returns the number of codes that differ."""
    moved = 0
    for gl, wl in zip(got, want):
        for name in ("k", "v"):
            codes = gl[name].numpy().astype(np.int32)
            ref = np.asarray(wl[name]).astype(np.int32)
            diff = np.abs(codes - ref)
            assert diff.max() <= 1, (where, name)
            assert (diff > 0).mean() <= EDGE_LANES, (where, name)
            moved += int((diff > 0).sum())
            np.testing.assert_allclose(gl[name + "_s"].numpy(),
                                       np.asarray(wl[name + "_s"]),
                                       rtol=SCALE_RTOL, atol=0,
                                       err_msg=f"{where} {name}_s")
    return moved


@pytest.mark.parametrize("arch", ARCHS)
def test_kv8_cache_matches_reference(arch):
    """A ragged prefill into the int8 cache, then three decode steps, in
    both packages: codes, scales and logits (see the module docstring)."""
    jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
    jp = JSP.init_split_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    B, S, cache = 3, 8, 32
    lens = np.array([8, 5, 3], np.int32)
    toks = np.random.default_rng(2).integers(
        1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jst = jax.jit(lambda p, t, s, n: JT.prefill(p, t, jcfg, s,
                                                    lengths=n))(
        jp, jnp.asarray(toks), JT.init_decode_state(jcfg, B, cache,
                                                    kv_bits=8),
        jnp.asarray(lens))
    jstep = jax.jit(lambda p, t, s, c: JT.decode_step(p, t, s, c, jcfg))
    tl, tst = TT.prefill(tp, torch.from_numpy(toks), tcfg,
                         TT.init_decode_state(tcfg, B, cache, kv_bits=8),
                         lengths=torch.from_numpy(lens))

    moved = 0

    def hold(where, got, want):
        nonlocal moved
        moved += _hold_cache(_attention_states(tcfg, tst),
                             _attention_states(jcfg, jst), where)
        want = np.asarray(want)
        rtol = FLIP_RTOL if moved else LOGIT_RTOL
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=rtol * np.abs(want).max(),
                                   err_msg=where)

    hold("prefill", tl, jl)
    tok, pos = np.argmax(np.asarray(jl), -1).astype(np.int32), lens.copy()
    for step in range(3):
        jl, jst = jstep(jp, jnp.asarray(tok), jst, jnp.asarray(pos))
        tl, tst = TT.decode_step(tp, torch.from_numpy(tok), tst,
                                 torch.from_numpy(pos), tcfg)
        hold(f"decode step {step}", tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        pos = pos + 1
