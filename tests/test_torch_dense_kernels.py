"""The kernel-side plans and plain versions that the dense archs
stablelm-3b, granite-8b and internlm2-20b reach, held on the CPU.

* ``boundary_plan`` at the (d, bank width) of every arch the port serves
  and at 4, 64 and 512 rows: the shared memory of a block never exceeds the
  card's 232,448 bytes, and the tile is the widest that fits (granite-8b
  two m-tiles and internlm2-20b one at a 64-row prefill); a bank no tile
  fits raises.
* ``tail_plan`` at the same archs' heads: the rows a block holds beside
  its ring fit, and 16 rows of internlm2-20b's d 6144 fall to halves of 8.
* The port's plain ``paged_attention_ref`` at head_dim 80 (stablelm-3b's)
  with GQA groups of 1 and 6, against the JAX oracle: bit for bit in bf16
  but where the two frameworks' f32 sums straddle a bf16 rounding edge (at
  most one element in 1000, by one ulp), within 1e-6 in f32.
* ``init_params`` builds each stacked layer leaf in place, layer by layer:
  the tensors are bit-identical to ``torch.stack`` of per-block inits drawn
  from the same generator, as the port made them before.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_flat
from repro_torch.kernels import ref as tref
from repro_torch.kernels.boundary_mixed import boundary_plan, tail_plan
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

SMEM_BLOCK = 232448     # shared memory a block may use on an H100
ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m", "stablelm-3b",
         "granite-8b", "internlm2-20b")
BF16 = torch.bfloat16


def _boundary_smem(mt, d, wmax, esz):
    """The kernels' shared memory at ``mt`` m-tiles, from their layout."""
    pad, kmax = 16 // esz, -(-wmax // 16) * 16
    down = esz * (512 * (16 * mt + pad) + 32 * (512 + pad) + 512)
    up = esz * (kmax * (16 * mt + pad) + 32 * (kmax + pad))
    return 4 * 4 * mt * 32 * 16 + max(down, up)


@pytest.mark.parametrize("N", [4, 64, 512])
@pytest.mark.parametrize("arch", ARCHS)
def test_boundary_plan_fits_and_is_widest(arch, N):
    cfg = get_config(arch)
    d, wmax = cfg.d_model, cfg.split.d_bottleneck
    mt, smem = boundary_plan(N, d, wmax, BF16)
    assert smem == _boundary_smem(mt, d, wmax, 2) and smem <= SMEM_BLOCK
    if N <= 32:
        assert mt == 1
    else:
        # every wider tile would overflow a block
        assert all(_boundary_smem(w, d, wmax, 2) > SMEM_BLOCK - 1024
                   for w in (4, 2) if w > mt)
    want64 = {"granite-8b": 2, "internlm2-20b": 1}.get(arch, 4)
    if N == 64:
        assert mt == want64
    if wmax <= 1024:                 # f32 (reduced configs): one m-tile
        assert boundary_plan(N, d, wmax, torch.float32)[0] == 1


def test_boundary_plan_raises_where_no_tile_fits():
    # f32 rows against internlm2-20b's 1536-lane bank: 328,192 bytes
    with pytest.raises(ValueError, match="shared memory"):
        boundary_plan(4, 6144, 1536, torch.float32)
    assert boundary_plan(4, 4096, 1024, torch.float32) == (1, 221696)


@pytest.mark.parametrize("arch", ARCHS)
def test_tail_plan_fits(arch):
    cfg = get_config(arch)
    d = cfg.d_model
    for rows in (1, 4, 8, 13, 16):
        cap, smem = tail_plan(d, cfg.tie_embeddings, rows)
        assert smem <= SMEM_BLOCK and cap >= min(rows, 8)
        assert cap == (8 if rows <= 8 or d == 6144 else 16)


def test_tail_plan_raises_where_no_rows_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tail_plan(10240, False, 4)


def _pair(a, name):
    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[name]
    j = jnp.asarray(a, dt)
    return j, params_from_flat({"a": np.asarray(j)}, device="cpu")["a"]


def _f(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("n_kv,g", [(4, 1), (2, 6)])
def test_paged_attention_ref_head_dim_80_matches_jax(n_kv, g, name):
    """head_dim 80, page_len 8, a ragged batch with a full table, junk in
    scratch page 0 and in rows past each position."""
    hd, plen, B, nb = 80, 8, 3, 5
    nq = n_kv * g
    n_pages = B * nb + 1
    rng = np.random.default_rng(80 + g)
    qj, qt = _pair(rng.normal(size=(B, nq, hd)), name)
    kj, kt = _pair(rng.normal(size=(n_pages, plen, n_kv, hd)), name)
    vj, vt = _pair(rng.normal(size=(n_pages, plen, n_kv, hd)), name)
    pos = np.array([nb * plen - 1, 0, 19], np.int32)
    bt = np.zeros((B, nb), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for b in range(B):
        for j in range(pos[b] // plen + 1):
            bt[b, j] = free.pop()
    got = _f(tref.paged_attention_ref(qt, kt, vt, torch.from_numpy(bt),
                                      torch.from_numpy(pos)))
    want = _f(jref.paged_attention_ref(qj, kj, vj, jnp.asarray(bt), pos))
    if name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    diff = got != want
    assert diff.mean() <= 1e-3, f"{diff.sum()} of {diff.size} differ"
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[diff]) + 1e-30)) - 7)
    np.testing.assert_array_less(np.abs(got[diff] - want[diff]), ulp * 1.01)


def _stacked_the_old_way(gen, cfg):
    """``init_params`` as the port wrote it before: every block made, then
    the per-leaf ``torch.stack`` (twice the layers' memory at its peak)."""
    dt = T.model_dtype(cfg)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    params = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                    dtype=dt)}
    params["layers"] = stack([T.block_init(gen, cfg, "attn")
                              for _ in range(cfg.n_layers)])
    params["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, dtype=dt)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         dtype=dt)
    return params


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "stablelm-3b", "granite-8b"])
def test_init_params_bit_identical_to_stacked_blocks(arch):
    cfg = dataclasses.replace(get_reduced(arch), n_layers=3)
    got = T.init_params(torch.Generator().manual_seed(5), cfg)
    want = _stacked_the_old_way(torch.Generator().manual_seed(5), cfg)
    gl, wl = T.tree_leaves(got), T.tree_leaves(want)
    assert len(gl) == len(wl) and set(got) == set(want)
    for a, b in zip(gl, wl):
        assert a.shape == b.shape and a.dtype == b.dtype == BF16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
