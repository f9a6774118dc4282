"""Host-side layout of the decode tail's tensor-core kernel, on the CPU.

The bf16 tail kernel computes only the real rows of each head-uniform row
block, in n-tiles of 8. Its dispatcher passes them: for one head the count
of rows (they sit first in the layout), for several heads a per-block count
from ``ops.head_rows``. Here that count is held against the layout itself:
block g's real rows are the rows whose slot ``dest`` falls in it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.boundary_mixed import decode_tail_grouped


def _rows_from_dest(dest, P, block_r):
    return np.bincount(dest.numpy() // block_r, minlength=P // block_r)


@pytest.mark.parametrize("n", [1, 4, 15, 16, 17, 40])
def test_head_rows_one_head(n):
    """One head: the rows fill the first blocks, the last one partly."""
    hidx = torch.zeros(n, dtype=torch.int32)
    dest, hid_g, P = ops.head_layout(hidx, 1, 16)
    rows = ops.head_rows(hidx, 1, 16)
    assert rows.dtype == torch.int32 and rows.shape == (P // 16,)
    np.testing.assert_array_equal(rows.numpy(), _rows_from_dest(dest, P, 16))
    want = [min(16, max(n - 16 * g, 0)) for g in range(P // 16)]
    np.testing.assert_array_equal(rows.numpy(), want)


@pytest.mark.parametrize("seed,n,H,block_r", [(0, 5, 3, 16), (1, 32, 3, 16),
                                              (2, 37, 4, 8), (3, 3, 5, 16)])
def test_head_rows_several_heads(seed, n, H, block_r):
    """Several heads: each head's run is padded to whole blocks; the count
    of a block is the rows of its head that land in it, 0 past the used
    span and for heads no row picked."""
    hidx = torch.from_numpy(np.random.default_rng(seed).integers(
        0, H, n).astype(np.int32))
    dest, hid_g, P = ops.head_layout(hidx, H, block_r)
    rows = ops.head_rows(hidx, H, block_r)
    got = rows.numpy()
    np.testing.assert_array_equal(got, _rows_from_dest(dest, P, block_r))
    assert got.sum() == n and got.max() <= block_r
    for g in np.nonzero(got)[0]:        # a block with rows holds its head's
        in_block = dest.numpy() // block_r == g
        assert (hidx.numpy()[in_block] == int(hid_g[g])).all()


def test_tail_wrapper_takes_row_counts_on_cpu():
    """The CPU path of the wrapper is the plain version whatever real-row
    counts it is given, and the dispatcher with several heads picks the
    serving reference's tokens."""
    rng = np.random.default_rng(5)
    d, V, H, n = 64, 256, 3, 9
    x = torch.from_numpy(rng.normal(size=(n, 1, d)).astype(np.float32)).to(
        torch.bfloat16)
    heads = torch.from_numpy(rng.normal(size=(H, d, V)).astype(
        np.float32)).to(torch.bfloat16)
    scale = torch.ones(d, dtype=torch.bfloat16)
    hidx = torch.from_numpy(rng.integers(0, H, n).astype(np.int32))
    dest, hid_g, P = ops.head_layout(hidx, H, 16)
    xp = torch.zeros((P, d), dtype=x.dtype)
    xp[dest] = x[:, 0]
    bias = torch.zeros_like(scale)
    plain = decode_tail_grouped(xp, heads, scale, bias, hid_g, block_r=16)
    for kw in ({"rows_g": ops.head_rows(hidx, H, 16)}, {"n_real": n}):
        tok = decode_tail_grouped(xp, heads, scale, bias, hid_g, block_r=16,
                                  **kw)
        assert torch.equal(tok, plain)
    want = ref.decode_tail_ref(x, scale, None, heads, hidx)
    got = ops.decode_tail_op(x, scale, None, heads, hidx)
    assert torch.equal(got, want)
    assert torch.equal(plain[dest], want[:, 0])
