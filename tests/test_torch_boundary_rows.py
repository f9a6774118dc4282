"""The boundary on rows in place, and the one-head decode tail without a
layout, on the CPU.

On the card the boundary kernel takes the rows as they lie and each of its
blocks finds the rows of its mode; its plain version
``ref.boundary_mixed_rows_ref`` computes each row alone, per mode, in the
kernel's order. Here that plain version is held against the port's serving
reference (the CPU dispatcher), the JAX oracle and, in bf16, the JAX Pallas
kernel run with ``interpret=True`` through its mode-grouped layout and
gathered back, on the bank of ``tests/test_torch_kernels_ref.py`` and on
the reduced configs' widths (32 / 16 / 24 / 8: narrower than a 128-lane
chunk, not all multiples of 16).
Mode-0 rows are copies, and each row of a pool is bit-identical to the
same row alone. The one-head tail reads its rows in place, so a row count
that is not a multiple of the row block gives the padded call's tokens.

Tolerance: in bf16 ``_assert_match``'s (bit for bit but for one ulp on at
most 1 element in 1000). In f32 the plain version's projections are the
exactly rounded sums (float64, rounded once) and the references' are f32
GEMMs in their own orders: at these widths those differ from the exact
sums by up to ~3e-6 at outputs of size 1-3 (serving 1.04x and JAX 1.13x
``_assert_match``'s 1e-6 at the [5, 3] prefill, where the two references,
sharing most of their order, are 0.78x apart), so f32 is held to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.boundary_mixed import (boundary_mixed_grouped,
                                                decode_tail_grouped)
from test_torch_kernels_ref import DT, HET_BANK, _assert_match, _f, _pair

REDUCED_BANK = [(32, 8), (16, 4), (24, 1), (8, 0)]
BANKS = {"het": HET_BANK, "reduced": REDUCED_BANK}
F32_TOL = 1e-5      # rtol and atol of the f32 comparisons (see above)
SHAPES = [(1, 1), (4, 1), (8, 1), (32, 1), (5, 3)]


def _bank(kind, name, d=128, seed=0):
    widths = BANKS[kind]
    rng = np.random.default_rng(seed)
    wmax = max(w for w, _ in widths)
    down = np.zeros((len(widths), d, wmax))
    up = np.zeros((len(widths), wmax, d))
    for i, (w, _) in enumerate(widths):
        down[i, :, :w] = rng.normal(size=(d, w)) / np.sqrt(d)
        up[i, :w, :] = rng.normal(size=(w, d)) / np.sqrt(w)
    jb, tb = {}, {}
    scale = 1 + 0.1 * rng.normal(size=(len(widths), d))
    for k, v in (("down_w", down), ("up_w", up), ("norm_scale", scale)):
        jb[k], tb[k] = _pair(v, name)
    for k, v in (("width", [w for w, _ in widths]),
                 ("bits", [b for _, b in widths])):
        jb[k] = jnp.asarray(v, jnp.int32)
        tb[k] = torch.tensor(v, dtype=torch.int32)
    return jb, tb


def _assert_rows_match(got, want, name):
    if name == "float32":
        np.testing.assert_allclose(_f(got), _f(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        _assert_match(got, want, name)


def _inputs(kind, name, B, S, d=128):
    jb, tb = _bank(kind, name, d)
    n_modes = len(BANKS[kind]) + 1
    rng = np.random.default_rng(B * 10 + S)
    modes = rng.integers(0, n_modes, B).astype(np.int32)
    if B >= n_modes:
        modes[:n_modes] = np.arange(n_modes)
    xj, xt = _pair(rng.normal(size=(B, S, d)), name)
    return jb, tb, modes, xj, xt


@pytest.mark.parametrize("kind", sorted(BANKS))
@pytest.mark.parametrize("name", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,S", SHAPES)
def test_rows_ref_matches_references(B, S, name, kind):
    """Pools of 1, 4, 8 and 32 rows and a [5, 3] prefill, every mode in one
    bank: the rows' plain version against the serving reference, the JAX
    oracle and (bf16) the interpreted Pallas kernel; mode-0 rows copied."""
    jb, tb, modes, xj, xt = _inputs(kind, name, B, S)
    d = xt.shape[-1]
    x2 = xt.reshape(B * S, d)
    rmode = torch.from_numpy(np.repeat(modes, S))
    got = tref.boundary_mixed_rows_ref(x2, rmode, tb, DT[name][1])
    assert got.dtype == x2.dtype and got.shape == x2.shape
    serving = tops.boundary_mixed_op(tb, xt, torch.from_numpy(modes),
                                     dtype=DT[name][1])
    _assert_rows_match(got, serving.reshape(B * S, d), name)
    want = jref.boundary_mixed_ref(jb, xj, jnp.asarray(modes),
                                   dtype=DT[name][0])
    _assert_rows_match(got, np.asarray(want, np.float32).reshape(B * S, d),
                       name)
    if name == "bfloat16" and kind == "het":
        pallas = jops.boundary_mixed_op(jb, xj, jnp.asarray(modes),
                                        dtype=DT[name][0], interpret=True)
        _assert_match(got, np.asarray(pallas, np.float32).reshape(B * S, d),
                      name)
    raw = rmode.numpy() == 0
    np.testing.assert_array_equal(_f(got)[raw], _f(x2)[raw])


@pytest.mark.parametrize("kind", sorted(BANKS))
@pytest.mark.parametrize("name", ["bfloat16", "float32"])
def test_rows_ref_row_alone_equals_row_in_pool(name, kind):
    """Each row of a 32-row mixed pool is bit-identical to the same row
    computed alone, and the wrapper's CPU path is the plain version."""
    jb, tb, modes, xj, xt = _inputs(kind, name, 32, 1)
    x2 = xt[:, 0]
    mt = torch.from_numpy(modes)
    pool = tref.boundary_mixed_rows_ref(x2, mt, tb, DT[name][1])
    for r in range(32):
        alone = tref.boundary_mixed_rows_ref(x2[r:r + 1], mt[r:r + 1], tb,
                                             DT[name][1])
        assert torch.equal(alone[0].view(torch.uint8),
                           pool[r].view(torch.uint8)), r
    wrapped = boundary_mixed_grouped(x2, mt, 1, tb, dtype=DT[name][1])
    assert torch.equal(wrapped.view(torch.uint8), pool.view(torch.uint8))
    x3 = xt.reshape(8, 4, -1)                 # [8, 4]: rows of sequences
    m3 = mt[:8]
    seq = boundary_mixed_grouped(x3.reshape(32, -1), m3, 4, tb,
                                 dtype=DT[name][1])
    plain = tref.boundary_mixed_rows_ref(x3.reshape(32, -1),
                                         m3.repeat_interleave(4), tb,
                                         DT[name][1])
    assert torch.equal(seq, plain)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("name,block_r", [("bfloat16", 16), ("float32", 8)])
@pytest.mark.parametrize("n", [1, 4, 13, 21])
def test_tail_rows_in_place_match_padded_call(n, name, block_r, tied):
    """One head, the rows in place (no head table, no bias): n rows, not a
    multiple of the row block, give the first n tokens of the padded call
    and of the serving reference."""
    rng = np.random.default_rng(n)
    d, V = 64, 384
    dt = DT[name][1]
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dt)
    head = rng.normal(size=(V, d) if tied else (d, V)).astype(np.float32)
    heads = torch.from_numpy(head).to(dt)[None]
    scale = torch.from_numpy(1 + 0.1 * rng.normal(size=d).astype(
        np.float32)).to(dt)
    tok = decode_tail_grouped(x, heads, scale, None, block_r=block_r,
                              tied=tied)
    assert tok.shape == (n,) and tok.dtype == torch.int32
    G = -(-n // block_r)
    xp = torch.zeros((G * block_r, d), dtype=dt)
    xp[:n] = x
    padded = decode_tail_grouped(xp, heads, scale, torch.zeros_like(scale),
                                 torch.zeros(G, dtype=torch.int32),
                                 block_r=block_r, tied=tied, n_real=n)
    assert torch.equal(tok, padded[:n])
    want = tref.decode_tail_ref(x[:, None], scale, None, heads, tied=tied)
    assert torch.equal(tok, want[:, 0])
    got = tops.decode_tail_op(x[:, None], scale, None, heads, tied=tied)
    assert torch.equal(got[:, 0], tok)
