"""The streaming RG-LRU scan's plan and a model of its schedule, on the
CPU.

The CUDA kernel (``csrc/rglru_scan.cu``) gives each block a tile of
channels of one batch row and streams a and b through a ring of
shared-memory stages (a copy warp fills slots with asynchronous copies and
writes h out, a scan warp walks time in order); ``scan_plan`` in
``kernels/rglru_scan.py`` picks the tile, the steps a stage, the ring depth
and the grid from the shapes.
Here the plan is checked to cover every channel and step once inside the
card's limits, and ``kernel_walk`` below runs the kernel's schedule on
the plan's shared-memory layout (slots, commit groups, the wait that
retires them, h written over a) with each copy landing as early or as
late as the hardware may let it. It is held bit for bit against the plain
scan and, within the FMA bound of ``tests/test_torch_recurrent.py``
(``S * 2**-23 * max|h|``: XLA on the CPU contracts ``a * h + b``), against
the JAX oracle and the interpreted Pallas kernel. The kernel itself is
held bit for bit against the plain scan on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.rglru_scan import STAGES, TILES, scan_plan

SS = (1, 7, 16, 64, 65, 2049)
DS = (1, 8, 37, 512, 1000, 2560)
H100_SMS = 132
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may take


def _inputs(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 1.0, (B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, h0


def _card_sizes(B, D):
    """SM counts at which the planner takes each tile it can for [B, *, D]
    (and the narrowest, on a card larger than any grid)."""
    return sorted({B * -(-D // c) for c in TILES} | {10 ** 9})


def kernel_walk(a, b, h0, plan, land):
    """``rglru_scan_kernel``'s schedule under ``plan``, every block at
    once: a buffer of ``plan.smem_bytes`` a block, NaN at the start, the a
    slots then the b slots, stage s in slot s % stages. Before round 0 the
    copy warp commits stages 0 .. stages - 3, one group each, and waits
    until at most stages - 3 groups are pending. Round s: the copy warp
    writes stage s - 1's h rows out of their slot, commits a group for
    stage s + stages - 2 (empty past the last stage) and waits again,
    while the scan warp walks stage s (a separately rounded multiply and
    add a step, each h written over its a). A copy skips channels past D
    and lands at its issue (``land="early"``, before the scan of the round)
    or only at the wait that retires its group (``"late"``). A slot that
    is refilled before its h is written out, or read before its copy
    lands, shows as wrong bits or NaN."""
    B, S, D = a.shape
    C, T, K = plan.tile, plan.steps, plan.stages
    n_tiles = plan.grid[0]
    assert plan.grid == (n_tiles, B) and (n_tiles - 1) * C < D <= n_tiles * C
    n_st = -(-S // T)
    words = plan.smem_bytes // 4
    b_base = min(K, n_st) * T * C
    nan = float("nan")
    smem = torch.full((B, n_tiles, words), nan)

    def tiled(x):                      # [B, n, D] -> [B, tiles, n, C]
        x = torch.nn.functional.pad(x, (0, n_tiles * C - D), value=nan)
        return x.view(B, x.shape[1], n_tiles, C).permute(0, 2, 1, 3)

    src = {0: tiled(a), b_base: tiled(b)}
    own = (torch.arange(n_tiles * C) < D).view(1, n_tiles, 1, C)
    out = torch.full((B, n_tiles, S, C), nan)

    def steps(s):
        return min(T, S - s * T)

    def slot(base, s):
        off, n = base + (s % K) * T * C, steps(s)
        assert off + n * C <= words, f"stage {s} past the shared memory"
        return smem[:, :, off:off + n * C].view(B, n_tiles, n, C)

    def copy(s):
        for base, x in src.items():
            dst = slot(base, s)
            dst.copy_(torch.where(own, x[:, :, s * T:s * T + steps(s)], dst))

    pending = []

    def commit(s):
        if s < n_st and land == "early":
            copy(s)
        pending.append(s if s < n_st and land == "late" else None)

    def wait():
        while len(pending) > K - 3:
            s = pending.pop(0)
            if s is not None:
                copy(s)

    carry = torch.zeros(B, n_tiles, C)
    if h0 is not None:
        carry = tiled(h0[:, None])[:, :, 0].nan_to_num()
    for s in range(K - 2):
        commit(s)
    wait()
    for s in range(n_st + 1):
        if s > 0:
            out[:, :, (s - 1) * T:(s - 1) * T + steps(s - 1)] = slot(0, s - 1)
        commit(s + K - 2)
        if s < n_st:
            sa, sb = slot(0, s), slot(b_base, s)
            for u in range(steps(s)):
                carry = sa[:, :, u] * carry + sb[:, :, u]
                sa[:, :, u] = carry
        wait()
    return out.permute(0, 2, 1, 3).reshape(B, S, n_tiles * C)[..., :D]


@pytest.mark.parametrize("D", DS)
def test_plan_covers_every_channel_and_step_once(D):
    """For every S and every tile the planner takes: the grid's tiles
    cover channels 0..D-1 once (only the last tile runs past D), the
    stages cover steps 0..S-1 once, the slots are those of the ring the
    scan uses, they fit, and 16-byte copies are planned only for aligned
    rows of a width that is a multiple of 4."""
    for S in SS:
        for n_sms in _card_sizes(4, D):
            p = scan_plan(4, S, D, n_sms)
            assert p.tile in TILES and p.grid[1] == 4
            chans = [i * p.tile + c for i in range(p.grid[0])
                     for c in range(p.tile) if i * p.tile + c < D]
            assert chans == list(range(D))
            assert p.grid[0] * p.tile - D < p.tile
            n_st = -(-S // p.steps)
            steps = [t for s in range(n_st)
                     for t in range(s * p.steps, min((s + 1) * p.steps, S))]
            assert steps == list(range(S))
            assert p.stages == STAGES >= 3 and p.steps <= S
            slots = min(p.stages, n_st)
            assert p.smem_bytes == 2 * slots * p.steps * p.tile * 4
            assert p.smem_bytes <= SMEM_LIMIT
            assert p.vec == (4 if D % 4 == 0 else 1)
            assert scan_plan(4, S, D, n_sms, aligned=False) == p._replace(
                vec=1)


@pytest.mark.parametrize("shape,blocks,tile", [
    ((4, 1024, 512), 256, 8),       # the kernel bench's scan
    ((4, 2048, 2560), 320, 32),     # a window-long prompt
    ((4, 16, 2560), 320, 32),       # the main path's prefill
    ((1, 16, 2560), 160, 16),
    ((3, 37, 1000), 189, 16),
])
def test_plan_fills_the_card(shape, blocks, tile):
    """The widest tile that still gives every SM a block: >= 128 blocks
    at the bench's and the long prompt's shapes; a prompt of at most T
    steps is one stage with every load issued at once."""
    B, S, D = shape
    p = scan_plan(B, S, D, H100_SMS)
    assert (p.tile, p.grid[0] * p.grid[1]) == (tile, blocks)
    assert blocks >= 128
    if S <= 1024 // tile:
        assert p.steps == S and p.smem_bytes == 2 * S * tile * 4
    else:
        assert p.steps * p.tile == 1024
        assert p.smem_bytes == 2 * min(STAGES, -(-S // p.steps)) * 4096


@pytest.mark.parametrize("bad", [(0, 4, 8), (2, 0, 8), (2, 4, 0),
                                 (65536, 4, 8)])
def test_plan_refuses_shapes_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        scan_plan(*bad)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S", SS)
def test_tiled_mirror_is_bit_for_bit(S, with_h0):
    """Every ragged width, every tile the planner takes there, copies
    landing early and late: the kernel's schedule gives the plain scan's
    bits."""
    for D in DS:
        a, b, h0 = (torch.from_numpy(x) for x in _inputs(2, S, D, seed=D))
        h0 = h0 if with_h0 else None
        want = TREF.rglru_scan_ref(a, b, h0)
        for n_sms in _card_sizes(2, D):
            plan = scan_plan(2, S, D, n_sms)
            for land in ("early", "late"):
                got = kernel_walk(a, b, h0, plan, land)
                assert torch.equal(got, want), (S, D, plan, land)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("shape", [(2, 64, 512), (3, 16, 256),
                                   (2, 65, 37), (1, 7, 1000)])
def test_tiled_mirror_matches_jax(shape, with_h0):
    """Against the JAX oracle and the Pallas kernel in interpret mode (S
    a multiple of 8 and D of 128 reach the kernel; other shapes take the
    oracle there too), within the FMA bound of the module doc."""
    B, S, D = shape
    a, b, h0 = _inputs(B, S, D, seed=S)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    got = kernel_walk(torch.from_numpy(a), torch.from_numpy(b), th0,
                      scan_plan(B, S, D, H100_SMS), "late").numpy()
    oracle = np.asarray(JREF.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                            jh0))
    pallas = np.asarray(JOPS.rglru_scan_op(jnp.asarray(a), jnp.asarray(b),
                                           jh0, interpret=True))
    tol = S * 2.0 ** -23 * float(np.abs(oracle).max())
    np.testing.assert_allclose(got, oracle, rtol=0, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)
