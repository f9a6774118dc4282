"""The port's split prefill and mixed-mode decode against the JAX package.

Weights come from the JAX package's ``init_split_params`` and cross over
through ``repro_torch.convert`` (both the in-memory flat tree and a
checkpoint ``.npz``). On the reduced qwen2.5-3b config in float32, both
packages prefill a ragged batch into a paged arena and decode a few
mixed-mode steps: logits agree to 1e-4 (f32 sums in two orders through a
few layers), arenas to 1e-5, and argmax tokens are equal.
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
from repro.models import transformer as JT
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import load_npz, params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core import split as TSP
from repro_torch.models import transformer as TT

PAGE = 8


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_reduced("qwen2.5-3b"), dtype="float32")
    tcfg = dataclasses.replace(t_reduced("qwen2.5-3b"), dtype="float32")
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tables(lens, extra):
    """Block tables covering each row's prompt plus ``extra`` decode rows;
    pages handed out in a shuffled order, unallocated entries at page 0."""
    need = [-(-(n + extra) // PAGE) for n in lens]
    nb, n_pages = max(need), sum(need)
    free = list(np.random.default_rng(1).permutation(np.arange(1,
                                                               n_pages + 1)))
    bt = np.zeros((len(lens), nb), np.int32)
    for b, n in enumerate(need):
        for j in range(n):
            bt[b, j] = free.pop()
    return bt, n_pages


def _f(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def test_params_convert_exactly(models, tmp_path):
    """In memory and through a checkpoint .npz (bf16 as a uint16 view with
    the ``__meta__`` dtype table), every leaf crosses bit for bit."""
    jcfg, _, jp, tp = models
    jflat = checkpoint._flatten(jp)
    assert len(tp["bneck_modes"]) == len(jp["bneck_modes"])
    for k, v in jflat.items():
        node = tp
        for part in k.split("/"):
            node = node[int(part)] if isinstance(node, tuple) else node[part]
        np.testing.assert_array_equal(node.numpy(), v)
    jbf = JSP.init_split_params(jax.random.PRNGKey(1),
                                j_reduced("qwen2.5-3b"))
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, jbf)
    tbf = load_npz(path, device="cpu")
    assert tbf["layers"]["mix"]["wq"]["w"].dtype == torch.bfloat16
    for k, v in checkpoint._flatten(jbf).items():
        node = tbf
        for part in k.split("/"):
            node = node[int(part)] if isinstance(node, tuple) else node[part]
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(v, np.float32))


def test_split_prefill_then_mixed_decode_match(models):
    jcfg, tcfg, jp, tp = models
    lens = np.array([16, 5, 9], np.int32)
    steps = 4
    bt, n_pages = _tables(lens, steps)
    B, S = len(lens), 16
    rng = np.random.default_rng(0)
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    modes = np.array([0, 1, 1], np.int32)

    jst = JT.init_decode_state(jcfg, n_pages + 1, PAGE)
    tst = TT.init_decode_state(tcfg, n_pages + 1, PAGE)
    jstack = JB.bank_stack(jp["bneck_modes"], jcfg.split)
    tstack = TB.bank_stack(tp["bneck_modes"], tcfg.split)
    jl, jst = JSP.split_prefill_mixed(
        jp, jstack, jnp.asarray(toks), jst, jcfg, jnp.asarray(modes),
        lengths=jnp.asarray(lens), block_table=jnp.asarray(bt))
    tl, tst = TSP.split_prefill_mixed(
        tp, tstack, torch.from_numpy(toks), tst, tcfg,
        torch.from_numpy(modes), lengths=torch.from_numpy(lens),
        block_table=torch.from_numpy(bt))
    assert tl.shape == (B, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_f(tl), _f(jl), rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(_f(tst[k]), _f(jst[k]), rtol=1e-5,
                                   atol=1e-5)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok)

    pos = lens.copy()
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
        np.testing.assert_allclose(_f(tl), _f(jl), rtol=1e-4, atol=1e-4)
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), tok)
        np.testing.assert_array_equal(tt.numpy(), tok)
        pos = pos + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(_f(tst[k]), _f(jst[k]), rtol=1e-5,
                                   atol=1e-5)
