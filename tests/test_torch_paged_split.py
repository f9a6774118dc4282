"""The split order of the paged-attention kernels, held on the CPU.

``csrc/paged_attention.cu`` computes the reference's online softmax in
another order: per range of pages the scores and page maxima, then the
prefix max, each page's p / corr / psum / pv, and last the serial l / acc
combine. ``ref.paged_attention_split_ref`` mirrors that order in torch.
Here it is held

* bit for bit against the port's sequential ``paged_attention_ref``, in
  bf16 and f32, at 1, 2, 3 and nb pages a range, on normal inputs: the split
  order gives the same values, not nearly the same;
* against the JAX package's ``paged_attention_ref`` and its Pallas kernel
  run with ``interpret=True``: bit for bit in bf16; in f32 within 1e-6,
  because XLA's and torch's f32 ``exp`` on the CPU differ in the last bit on
  about one argument in ten (and the JAX oracle and its interpreted kernel
  differ from each other in f32 too). The cross-framework inputs lie on a
  grid of eighths, so every f32 dot product is exact in any summation order
  and a bf16 difference can only come from the order of the algorithm, which
  is what is tested; the normal-input case above covers the rest.

Positions cover 0, a page's last row, a page's first row, ragged values
across page edges and a full table, with junk in scratch page 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as j_paged_kernel
from repro_torch.convert import params_from_flat
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import (ONE_RANGE_PAGES,
                                                 pages_per_split_for)

DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
HD, PLEN, NB, N_KV, G = 64, 4, 9, 2, 4
SPLITS = [1, 2, 3, NB]


def _inputs(name, seed, grid):
    """(jax q, k, v), (torch q, k, v), block table, positions. ``grid``:
    values n / 8 with |n| <= 8, else normal."""
    rng = np.random.default_rng(seed)
    nq = N_KV * G
    pos = np.array([0, PLEN - 1, 2 * PLEN + 3, NB * PLEN - 1, 5 * PLEN],
                   np.int32)
    B = len(pos)
    n_pages = B * NB + 1

    def draw(shape):
        if grid:
            return rng.integers(-8, 9, size=shape) / 8.0
        return rng.normal(size=shape)

    arrs = [draw((B, nq, HD)), draw((n_pages, PLEN, N_KV, HD)),
            draw((n_pages, PLEN, N_KV, HD))]
    for a in arrs[1:]:
        a[0] = 50.0 * rng.normal(size=a[0].shape)   # junk in scratch page 0
    bt = np.zeros((B, NB), np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for b in range(B):
        for j in range(pos[b] // PLEN + 1):
            bt[b, j] = free.pop()
    js = [jnp.asarray(a, DT[name]) for a in arrs]
    ts = [params_from_flat({"a": np.asarray(j)}, device="cpu")["a"]
          for j in js]
    return js, ts, bt, pos


def _f(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("pps", SPLITS)
@pytest.mark.parametrize("name", ["bfloat16", "float32"])
def test_split_oracle_equals_sequential_ref(name, pps):
    """Normal inputs: the split mirror equals the port's sequential plain
    version bit for bit, and so does the CPU dispatcher's path."""
    _, (q, k, v), bt, pos = _inputs(name, seed=pps, grid=False)
    bt_t, pos_t = torch.from_numpy(bt), torch.from_numpy(pos)
    got = tref.paged_attention_split_ref(q, k, v, bt_t, pos_t, pps)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    want = tref.paged_attention_ref(q, k, v, bt_t, pos_t)
    assert torch.equal(got, want)
    assert torch.equal(tops.paged_attention_op(q, k, v, bt_t, pos_t), got)


@pytest.mark.parametrize("pps", SPLITS)
@pytest.mark.parametrize("name", ["bfloat16", "float32"])
def test_split_oracle_matches_jax(name, pps):
    """Grid inputs: the split mirror against the JAX oracle and the
    interpreted Pallas kernel (bf16 bit for bit, f32 within 1e-6)."""
    (qj, kj, vj), (q, k, v), bt, pos = _inputs(name, seed=10 + pps,
                                               grid=True)
    got = _f(tref.paged_attention_split_ref(
        q, k, v, torch.from_numpy(bt), torch.from_numpy(pos), pps))
    want = _f(jref.paged_attention_ref(qj, kj, vj, jnp.asarray(bt), pos))
    kern = _f(j_paged_kernel(qj, kj, vj, jnp.asarray(bt), jnp.asarray(pos),
                             interpret=True))
    for other in (want, kern):
        if name == "bfloat16":
            np.testing.assert_array_equal(got, other)
        else:
            np.testing.assert_allclose(got, other, rtol=1e-6, atol=1e-6)


def test_split_oracle_negative_position_has_no_pages():
    """A position below 0 walks no page, as the reference's page guard
    does: 0 / 0 on both sides."""
    _, (q, k, v), bt, pos = _inputs("float32", seed=3, grid=False)
    pos = pos.copy()
    pos[1] = -1
    got = tref.paged_attention_split_ref(q, k, v, torch.from_numpy(bt),
                                         torch.from_numpy(pos), 2)
    want = tref.paged_attention_ref(q, k, v, torch.from_numpy(bt),
                                    torch.from_numpy(pos))
    assert torch.isnan(got[1]).all() and torch.isnan(want[1]).all()
    assert torch.equal(got[[0, 2, 3, 4]], want[[0, 2, 3, 4]])


@pytest.mark.parametrize("B,n_kv,nb,want", [
    (4, 2, 4, 4),          # the main path's decode table: one range
    (8, 2, ONE_RANGE_PAGES, ONE_RANGE_PAGES),
    (8, 2, 125, 8),        # chip_smoke's long table: 16 ranges of 8 pages
    (1, 1, 128, 4),        # few sequences: ranges of the 4-page floor
    (64, 2, 40, 14),       # 128 (sequence, KV head) pairs: three ranges
    (160, 2, 40, 40),      # many sequences already fill the card
])
def test_pages_per_split_for(B, n_kv, nb, want):
    """The dispatcher's range size: one range for a narrow table, else
    about two blocks an SM of 132 for full sequences, never under 4 pages."""
    pps = pages_per_split_for(B, n_kv, nb, 132)
    assert pps == want
    ranges = -(-nb // pps)
    assert ranges * pps >= nb and (ranges - 1) * pps < nb
