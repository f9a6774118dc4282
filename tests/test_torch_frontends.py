"""The frontend archs in the port against the JAX package: musicgen-large
(K codebook streams summed at the input, one LM head a codebook, the
decode tail's norm / logits / argmax chain) and llava-next-34b (a vision
prefix of patch embeddings before the text).

Reduced configs in float32, weights from the JAX init carried across by
``repro_torch.convert``, tokens and the prefix drawn with numpy from a
seed. Logits, caches and arenas are held to ``LOGIT_RTOL`` times their
largest magnitude (f32 sums in other orders through two layers, as in
``tests/test_torch_dense_archs.py``); tokens, wire bytes and argmaxes must
be equal. The first train step follows ``tests/test_torch_train_loop.py``'s
tolerances: the loss within ``LOSS_ABS`` + ``LOSS_REL`` of its value, each
leaf's gradient within ``GRAD_REL`` of its scale (its largest |g|, at least
``GRAD_FLOOR`` of any leaf's). The bf16 codebook sum must be bit for bit
(f32 accumulation, one rounding, as ``jnp.sum``), and a K-stacked
checkpoint must read both ways bit for bit.
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
from repro.data import tokens as jtokens
from repro.models import transformer as JT
from repro.training import checkpoint as jckpt
from repro.training import loop as JL
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import (flat_from_params, flat_tensors,
                                 params_from_flat)
from repro_torch.core import bottleneck as TB
from repro_torch.core import cascade as TC
from repro_torch.core import split as TSP
from repro_torch.data import tokens as ttokens
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import loop as TL

ARCHS = ("musicgen-large", "llava-next-34b")
LOGIT_RTOL = 2e-6
LOSS_ABS, LOSS_REL = 1e-5, 1e-6
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-3
B, S, CACHE, PAGE = 3, 8, 48, 8
LENS = np.array([8, 5, 3], np.int32)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced shapes: one intra-op thread is enough, and the test workers
    beside this one keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MOE = ("phi3.5-moe-42b-a6.6b", "mixtral-8x7b")
# tests/test_configs_smoke.py's assignment table
ASSIGNMENT = {
    "musicgen-large": (48, 2048, 32, 32, 8192, 2048),
    "stablelm-3b": (32, 2560, 32, 32, 6912, 50304),
    "llava-next-34b": (60, 7168, 56, 8, 20480, 64000),
    "qwen2.5-3b": (36, 2048, 16, 2, 11008, 151936),
    "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064),
    "mixtral-8x7b": (32, 4096, 32, 8, 14336, 32000),
    "internlm2-20b": (48, 6144, 48, 8, 16384, 92544),
    "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
    "granite-8b": (36, 4096, 32, 8, 14336, 49152),
    "xlstm-125m": (12, 768, 4, 4, 0, 50304),
}


def test_registry_and_full_configs():
    """``ARCH_IDS`` is the reference's; every arch's full config matches
    the assignment table, and the frontend and MoE configs (full and
    reduced) equal the reference's field for field, with the reference's
    parameter counts."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    assert ARCH_IDS == J_ARCH_IDS
    for arch, (L_, d, h, kv, ff, v) in ASSIGNMENT.items():
        c = t_config(arch)
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
                c.vocab_size) == (L_, d, h, kv, ff, v), arch
    for arch in (*ARCHS, *MOE):
        for tget, jget in ((t_config, j_config), (t_reduced, j_reduced)):
            assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(
                jget(arch))
    assert round(t_config("llava-next-34b").param_count() / 1e9, 2) == 34.39
    assert round(t_config("musicgen-large").param_count() / 1e9, 2) == 3.24
    assert round(t_config("phi3.5-moe-42b-a6.6b").param_count() / 1e9,
                 2) == 41.87
    assert round(t_config("mixtral-8x7b").param_count() / 1e9, 2) == 46.70
    for arch in MOE:
        assert t_config(arch).param_count() == j_config(arch).param_count()


def test_token_batches_match_reference():
    """``token_batch_shapes`` / ``make_batch`` / ``MarkovTokenSource``: the
    same arrays as the reference's (audio [B, K, S], the vision prefix)."""
    for arch in (*ARCHS, "qwen2.5-3b"):
        cfg = t_reduced(arch)
        for kind in ("train", "decode"):
            assert ttokens.token_batch_shapes(cfg, 2, 40, kind) == \
                jtokens.token_batch_shapes(cfg, 2, 40, kind)
            got = ttokens.make_batch(cfg, 2, 40, kind, step=3, seed=1)
            want = jtokens.make_batch(cfg, 2, 40, kind, step=3, seed=1)
            assert sorted(got) == sorted(want)
            assert all(np.array_equal(got[k], want[k]) for k in want)
        got = ttokens.MarkovTokenSource(cfg, seed=7).batch(2, 8, 1)
        want = jtokens.MarkovTokenSource(cfg, seed=7).batch(2, 8, 1)
        assert all(np.array_equal(got[k], want[k]) for k in want)


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


def _inputs(cfg, batch: int, seq: int, seed: int = 0):
    """Tokens ([B, K, S] audio) and, for vision, a prefix, from numpy."""
    rng = np.random.default_rng(seed)
    shape = ((batch, cfg.n_codebooks, seq) if cfg.frontend == "audio"
             else (batch, seq))
    toks = rng.integers(1, cfg.vocab_size, shape).astype(np.int32)
    emb = (rng.normal(0, 1, (batch, cfg.n_vision_tokens, cfg.d_model))
           .astype(np.float32) if cfg.frontend == "vision" else None)
    return toks, emb


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, floor=0.0):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_RTOL * max(
        np.abs(want).max(), floor))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_embedding_matches_reference(arch, models):
    """The bf16 embedding: the codebook rows summed in f32 and rounded
    once (musicgen), the prefix cast and put before the text (llava), bit
    for bit."""
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = {"embed": jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                models(arch)[2]["embed"])}
    tp = params_from_flat(jckpt._flatten(jp), device="cpu")
    toks, emb = _inputs(jcfg, 4, 16, seed=5)
    want = JT.embed_tokens(jp, _j(toks), jcfg, _j(emb))
    got = TT.embed_tokens(tp, _t(toks), tcfg, _t(emb))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, models):
    """``T.forward(embeddings=)``; ``T.prefill`` over ragged rows (lengths
    counting the prefix) into the dense cache, then two decode steps with
    [B, K, 1] audio tokens: logits, the cache and the decode tail's
    tokens (the codebook heads' chain for audio)."""
    jcfg, tcfg, jp, tp = models(arch)
    toks, emb = _inputs(jcfg, B, S)
    jl, _ = jax.jit(lambda p, t, e: JT.forward(p, t, jcfg, embeddings=e))(
        jp, _j(toks), _j(emb))
    tl, _ = TT.forward(tp, _t(toks), tcfg, embeddings=_t(emb))
    _close(tl, jl)
    nv = jcfg.n_vision_tokens if emb is not None else 0
    lens = LENS + nv
    jl, jst = jax.jit(lambda p, t, s, n, e: JT.prefill(
        p, t, jcfg, s, lengths=n, embeddings=e))(
            jp, _j(toks), JT.init_decode_state(jcfg, B, CACHE),
            jnp.asarray(lens), _j(emb))
    tl, tst = TT.prefill(tp, _t(toks), tcfg,
                         TT.init_decode_state(tcfg, B, CACHE),
                         lengths=torch.from_numpy(lens), embeddings=_t(emb))
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    pos = lens.copy()
    step = jax.jit(lambda p, t, s, c: JT.decode_step(p, t, s, c, jcfg))
    for _ in range(2):
        jl, jst = step(jp, jnp.asarray(tok), jst, jnp.asarray(pos))
        st = TT.tree_map(lambda a: a.clone(), tst)
        ttok, _ = TT.decode_step(tp, torch.from_numpy(tok), st,
                                 torch.from_numpy(pos), tcfg,
                                 return_tokens=True)
        tl, tst = TT.decode_step(tp, torch.from_numpy(tok), tst,
                                 torch.from_numpy(pos), tcfg)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        assert ttok.shape == tok.shape and np.array_equal(ttok.numpy(), tok)
        pos = pos + 1
    for k in ("k", "v"):
        _close(tst[k], jst[k], floor=1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_forward_every_mode_matches_reference(arch, models):
    """``split_forward(embeddings=)`` in every mode: logits and the wire
    bytes (which count the embedded sequence, prefix included)."""
    jcfg, tcfg, jp, tp = models(arch)
    toks, emb = _inputs(jcfg, 2, S, seed=1)
    for mode in range(jcfg.split.n_modes):
        jl, _, jinfo = JSP.split_forward(jp, _j(toks), jcfg, mode,
                                         embeddings=_j(emb))
        tl, _, tinfo = TSP.split_forward(tp, _t(toks), tcfg, mode,
                                         embeddings=_t(emb))
        _close(tl, jl)
        assert tinfo["payload_bytes"] == jinfo["payload_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_split_paged_mixed_steps_match_reference(arch, models):
    """``split_prefill_mixed`` into a paged arena, then two
    ``split_decode_step_mixed`` ticks with modes rolling over the rows:
    logits, the arena and the tail's tokens."""
    jcfg, tcfg, jp, tp = models(arch)
    toks, _ = _inputs(jcfg, B, S, seed=2)
    need = [-(-(int(n) + 2) // PAGE) for n in LENS]
    n_pages = sum(need)
    bt = np.zeros((B, max(need)), np.int32)
    free = list(np.random.default_rng(1).permutation(np.arange(
        1, n_pages + 1)))
    for b, n in enumerate(need):
        bt[b, :n] = [free.pop() for _ in range(n)]
    modes = np.array([0, 1, 1], np.int32)
    jstack = JB.bank_stack(jp["bneck_modes"], jcfg.split)
    tstack = TB.bank_stack(tp["bneck_modes"], tcfg.split)
    jl, jst = jax.jit(lambda p, k, t, s, m, n, b: JSP.split_prefill_mixed(
        p, k, t, s, jcfg, m, lengths=n, block_table=b))(
            jp, jstack, jnp.asarray(toks), JT.init_decode_state(
                jcfg, n_pages + 1, PAGE), jnp.asarray(modes),
            jnp.asarray(LENS), jnp.asarray(bt))
    jstep = jax.jit(lambda p, k, t, s, c, m, b: JSP.split_decode_step_mixed(
        p, k, t, s, c, jcfg, m, block_table=b))
    tl, tst = TSP.split_prefill_mixed(
        tp, tstack, torch.from_numpy(toks), TT.init_decode_state(
            tcfg, n_pages + 1, PAGE), tcfg, torch.from_numpy(modes),
        lengths=torch.from_numpy(LENS), block_table=torch.from_numpy(bt))
    _close(tl, jl)
    tok, pos = np.array(jnp.argmax(jl, -1), np.int32), LENS.copy()
    for step in range(2):
        m = np.roll(modes, step)
        jl, jst = jstep(jp, jstack, jnp.asarray(tok), jst, jnp.asarray(pos),
                        jnp.asarray(m), jnp.asarray(bt))
        args = (tp, tstack, torch.from_numpy(tok), tst,
                torch.from_numpy(pos), tcfg, torch.from_numpy(m),
                torch.from_numpy(bt))
        tt, _ = TSP.split_decode_step_mixed(*args, return_tokens=True)
        tl, tst = TSP.split_decode_step_mixed(*args)
        _close(tl, jl)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(tt.numpy(), tok)
        pos = pos + 1
    for k in ("k", "v"):
        _close(tst[k], jst[k], floor=1.0)


def _batch(cfg, seed=0):
    """The trainer's batch: Markov tokens and, for vision, the prefix
    from ``make_batch`` (the text then has --seq less the prefix)."""
    text = jtokens.token_batch_shapes(cfg, 2, 24, "train")["tokens"][-1]
    batch = jtokens.MarkovTokenSource(cfg, seed=seed).batch(2, text, 0)
    if cfg.frontend == "vision":
        batch["embeddings"] = jtokens.make_batch(cfg, 2, 24, step=0,
                                                 seed=seed)["embeddings"]
    return batch


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS
                                       for m in (None, 0, 1)])
def test_first_train_step_loss_and_gradients(arch, mode, models):
    """The loss and every leaf's gradient of the first train step in modes
    None, 0 and 1 (the vision loss cut to the text positions); a leaf
    outside the graph (the bank in modes None and 0) has no gradient, as
    the reference's zeros."""
    jcfg, tcfg, jp, tp = models(arch)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        JL.make_loss_fn(jcfg, mode=mode), has_aux=True))(jp, jb)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t = TL.make_loss_fn(tcfg, mode=mode)
    (tloss, _), tg = TC.value_and_grad(lambda p, b, _: loss_t(p, b), tp, tb,
                                       mode)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_REL,
                               atol=LOSS_ABS)
    g_want, g_got = jckpt._flatten(jg), flat_from_params(tg)
    assert set(g_got) <= set(g_want)
    assert all(not np.any(g_want[k]) for k in set(g_want) - set(g_got))
    top = max(float(np.abs(g).max()) for g in g_want.values())
    for k, g in g_want.items():
        big = max(float(np.abs(g).max()), GRAD_FLOOR * top)
        gk = g_got.get(k, np.zeros_like(g))
        assert np.all(np.abs(gk - g) <= GRAD_REL * big), k


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_codebook_checkpoint_both_ways(tmp_path):
    """A musicgen-large checkpoint (K-stacked ``embed.table`` [K, V, d] and
    ``lm_head.w`` [K, d, V], bf16) written by either package restores in
    the other bit for bit."""
    cfg = t_reduced("musicgen-large")
    jp = JSP.init_split_params(jax.random.PRNGKey(3), j_reduced(cfg.name))
    tp = TSP.init_split_params(torch.Generator().manual_seed(1), cfg)
    K, V, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
    assert tuple(tp["embed"]["table"].shape) == (K, V, d)
    assert tuple(tp["lm_head"]["w"].shape) == (K, d, V)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t.npz")
    jckpt.save(jpath, jp, {"arch": cfg.name})
    tckpt.save(tpath, tp, {"arch": cfg.name})
    got = flat_tensors(tckpt.restore(jpath + ".npz", tp))
    want = jckpt._flatten(jp)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        np.testing.assert_array_equal(_bits(t), _jbits(want[k]))
    back = jckpt._flatten(jckpt.restore(tpath, jp))
    for k, t in flat_tensors(tp).items():
        np.testing.assert_array_equal(_jbits(back[k]), _bits(t))
