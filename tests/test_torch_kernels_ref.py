"""The port's plain kernel versions and row layouts against the JAX package.

Each of ``boundary_mixed_grouped_ref``, ``decode_tail_grouped_ref`` and
``paged_attention_ref`` is held against both the JAX oracle of
``repro.kernels.ref`` and the JAX Pallas kernel run with ``interpret=True``,
at 128-aligned shapes, on the same numpy inputs. In bf16 the outputs are
pinned bit for bit, as ``tests/test_kernels.py`` and ``tests/test_paged.py``
pin the Pallas kernels (the model-dtype rounding barriers quantize away the
summation order of the f32 sums), except where an f32 sum of the two
frameworks straddles a bf16 rounding edge: at most one element in 1000 may
differ, and by one bf16 ulp. In f32 the barriers are no-op casts, so the two
sides agree to a few ulp (1e-6). The Pallas kernels run in interpret mode
in bf16, their pinned dtype.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.boundary_mixed import (boundary_mixed_grouped as
                                          j_boundary_kernel,
                                          decode_tail_grouped as j_tail_kernel)
from repro.kernels.paged_attention import paged_attention as j_paged_kernel
from repro_torch.convert import params_from_flat
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# widths: the full wmax, narrow, a non-chunk-aligned width; bits: int8 /
# int4 / ternary / unquantized (the bank of tests/test_kernels.py)
HET_BANK = [(128, 8), (256, 4), (200, 1), (384, 0)]


def _pair(a, name):
    """numpy -> (jax array, torch tensor) holding the same bits."""
    j = jnp.asarray(a, DT[name][0])
    return j, _t(j)


def _t(a):
    return params_from_flat({"a": np.asarray(a)}, device="cpu")["a"]


def _f(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _bank(name, d=128, seed=0):
    rng = np.random.default_rng(seed)
    wmax = max(w for w, _ in HET_BANK)
    down = np.zeros((len(HET_BANK), d, wmax))
    up = np.zeros((len(HET_BANK), wmax, d))
    for i, (w, _) in enumerate(HET_BANK):
        down[i, :, :w] = 0.05 * rng.normal(size=(d, w))
        up[i, :w, :] = 0.05 * rng.normal(size=(w, d))
    jb, tb = {}, {}
    scale = 1 + 0.1 * rng.normal(size=(len(HET_BANK), d))
    for k, v in (("down_w", down), ("up_w", up), ("norm_scale", scale)):
        jb[k], tb[k] = _pair(v, name)
    for k, v in (("width", [w for w, _ in HET_BANK]),
                 ("bits", [b for _, b in HET_BANK])):
        jb[k] = jnp.asarray(v, jnp.int32)
        tb[k] = torch.tensor(v, dtype=torch.int32)
    return jb, tb


def _assert_match(got, want, name):
    got, want = _f(got), _f(want)
    if name == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        return
    # bit for bit, except where the two frameworks' f32 sums straddle a
    # bf16 rounding edge: then one element differs by one bf16 ulp
    diff = got != want
    assert diff.mean() <= 1e-3, f"{diff.sum()} of {diff.size} differ"
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[diff]) + 1e-30)) - 7)
    np.testing.assert_array_less(np.abs(got[diff] - want[diff]), ulp * 1.01)


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S", [(1, 1), (8, 1), (32, 1), (5, 3)])
def test_boundary_grouped_ref_matches_jax(B, S, name):
    """Pools of 1, 8 and 32 rows and prefill rows, every mode (0 included)
    in one bank: layout tables equal, outputs bit for bit in bf16."""
    jb, tb = _bank(name)
    rng = np.random.default_rng(B * 10 + S)
    modes = rng.integers(0, len(HET_BANK) + 1, B).astype(np.int32)
    if B >= len(HET_BANK) + 1:
        modes[:len(HET_BANK) + 1] = np.arange(len(HET_BANK) + 1)
    xj, xt = _pair(rng.normal(size=(B, S, 128)), name)
    block_r = 16 if name == "bfloat16" else 8
    rmode = np.repeat(modes, S)
    jdest, jtb = jops.group_layout(jb, jnp.asarray(rmode), block_r, 128)
    tdest, ttb = tops.group_layout(tb, torch.from_numpy(rmode), block_r, 128)
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    assert ttb["P"] == jtb["P"]
    for k in ("hid", "nchunk", "width", "bits"):
        np.testing.assert_array_equal(ttb[k].numpy(), np.asarray(jtb[k]))

    xpj = jnp.zeros((jtb["P"], 128), xj.dtype).at[jdest].set(
        xj.reshape(B * S, 128))
    xpt = torch.zeros((ttb["P"], 128), dtype=xt.dtype)
    xpt[tdest] = xt.reshape(B * S, 128)
    targs = (xpt, tb["down_w"], tb["up_w"], tb["norm_scale"], ttb["hid"],
             ttb["nchunk"], ttb["width"], ttb["bits"])
    jargs = (xpj, jb["down_w"], jb["up_w"], jb["norm_scale"], jtb["hid"],
             jtb["nchunk"], jtb["width"], jtb["bits"])
    got = tref.boundary_mixed_grouped_ref(*targs, block_r=block_r,
                                          dtype=DT[name][1])
    want_ref = jref.boundary_mixed_grouped_ref(
        *jargs[:4], *[np.asarray(a) for a in jargs[4:]], block_r=block_r,
        dtype=DT[name][0])
    _assert_match(got, want_ref, name)
    if name == "bfloat16":
        _assert_match(got, j_boundary_kernel(*jargs, block_r=block_r,
                                             block_w=128, dtype=DT[name][0],
                                             interpret=True), name)
    raw = np.repeat(modes == 0, S)
    np.testing.assert_array_equal(_f(got)[tdest.numpy()][raw],
                                  _f(xt).reshape(B * S, 128)[raw])
    # and the CPU dispatcher (the serving reference) agrees with JAX's
    yt = tops.boundary_mixed_op(tb, xt, torch.from_numpy(modes),
                                dtype=DT[name][1])
    yj = jref.boundary_mixed_ref(jb, xj, jnp.asarray(modes),
                                 dtype=DT[name][0])
    _assert_match(yt, yj, name)


def _tail_inputs(B, name, H=1, V=512, d=128, seed=0):
    rng = np.random.default_rng(seed)
    x = _pair(rng.normal(size=(B, 1, d)), name)
    scale = _pair(1 + 0.1 * rng.normal(size=d), name)
    bias = _pair(0.1 * rng.normal(size=d), name)
    heads = _pair(rng.normal(size=(H, d, V)), name)
    return x, scale, bias, heads


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("norm_kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_decode_tail_grouped_ref_matches_jax(B, norm_kind, name):
    """Head-grouped layout over 3 heads, pool sizes 1/8/32: the port's
    blocked plain tail picks the same tokens as the JAX oracle and the
    Pallas kernel in interpret mode."""
    H = 3
    (xj, xt), (sj, st), (bj, bt), (hj, ht) = _tail_inputs(B, name, H=H,
                                                          seed=B)
    hidx = np.random.default_rng(B + 7).integers(0, H, B).astype(np.int32)
    block_r = 16 if name == "bfloat16" else 8
    jdest, jhid, jP = jops.head_layout(jnp.asarray(hidx), H, block_r)
    tdest, thid, tP = tops.head_layout(torch.from_numpy(hidx), H, block_r)
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(thid.numpy(), np.asarray(jhid))
    assert tP == jP
    xpj = jnp.zeros((jP, 128), xj.dtype).at[jdest].set(xj[:, 0])
    xpt = torch.zeros((tP, 128), dtype=xt.dtype)
    xpt[tdest] = xt[:, 0]
    got = tref.decode_tail_grouped_ref(xpt, ht, st, bt, thid,
                                       block_r=block_r, block_v=128,
                                       norm_kind=norm_kind)
    want = jref.decode_tail_grouped_ref(np.asarray(xpj), hj, sj, bj,
                                        np.asarray(jhid), block_r=block_r,
                                        block_v=128, norm_kind=norm_kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "bfloat16":
        want_k = j_tail_kernel(xpj, hj, sj, bj, jhid, block_r=block_r,
                               block_v=128, norm_kind=norm_kind,
                               interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_k))
    # the serving reference the CPU dispatcher takes picks them too
    bias_t = bt if norm_kind == "layernorm" else None
    bias_j = bj if norm_kind == "layernorm" else None
    tt = tops.decode_tail_op(xt, st, bias_t, ht, torch.from_numpy(hidx),
                             norm_kind=norm_kind)
    tj = jref.decode_tail_ref(xj, sj, bias_j, hj, jnp.asarray(hidx),
                              norm_kind=norm_kind)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_decode_tail_tie_break_lowest_index():
    """Equal maxima across vocab chunks: both plain tails keep the lowest
    index, as ``jnp.argmax`` does."""
    d, V = 128, 512
    x = torch.ones((4, 1, d), dtype=torch.bfloat16)
    scale = torch.ones(d, dtype=torch.bfloat16)
    assert (tops.decode_tail_op(x, scale, None,
                                torch.ones((1, d, V), dtype=torch.bfloat16))
            == 0).all()
    rng = np.random.default_rng(15)
    w = rng.normal(size=(1, d, V))
    w[:, :, 37] = 3.0
    w[:, :, 300] = 3.0                   # the same maximum in a later chunk
    wj, wt = _pair(w, "bfloat16")
    xp = torch.ones((16, d), dtype=torch.bfloat16)
    hid = torch.zeros(1, dtype=torch.int32)
    for tok in (tops.decode_tail_op(x, scale, None, wt)[:, 0],
                tref.decode_tail_grouped_ref(xp, wt, scale, torch.zeros_like(
                    scale), hid, block_r=16, block_v=128)[:4, 0]):
        np.testing.assert_array_equal(tok.numpy(), 37)
    want = jops.decode_tail_op(jnp.ones((4, 1, d), jnp.bfloat16),
                               jnp.ones(d, jnp.bfloat16), None, wj,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(want), 37)


@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,nb,n_kv,g", [(1, 2, 1, 2), (3, 4, 2, 3),
                                         (4, 6, 2, 8)])
def test_paged_attention_ref_matches_jax(B, nb, n_kv, g, name):
    """hd 128, page_len 8, junk in scratch page 0 and in rows past each
    position; the tables point unallocated entries at page 0."""
    hd, plen = 128, 8
    nq = n_kv * g
    n_pages = B * nb + 1
    rng = np.random.default_rng(B * 100 + g)
    qj, qt = _pair(rng.normal(size=(B, nq, hd)), name)
    kj, kt = _pair(rng.normal(size=(n_pages, plen, n_kv, hd)), name)
    vj, vt = _pair(rng.normal(size=(n_pages, plen, n_kv, hd)), name)
    pos = rng.integers(0, nb * plen, size=B).astype(np.int32)
    pos[0] = nb * plen - 1                         # a full table
    bt = np.zeros((B, nb), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for b in range(B):
        for j in range(pos[b] // plen + 1):
            bt[b, j] = free.pop()
    got = tref.paged_attention_ref(qt, kt, vt, torch.from_numpy(bt),
                                   torch.from_numpy(pos))
    assert got.dtype == DT[name][1]
    want = jref.paged_attention_ref(qj, kj, vj, jnp.asarray(bt), pos)
    _assert_match(got, want, name)
    if name == "bfloat16":
        _assert_match(got, j_paged_kernel(qj, kj, vj, jnp.asarray(bt),
                                          jnp.asarray(pos), interpret=True),
                      name)
    # the CPU dispatcher is the plain version
    _assert_match(tops.paged_attention_op(qt, kt, vt, torch.from_numpy(bt),
                                          torch.from_numpy(pos)), want, name)
