"""The arithmetic of the port's two Hopper wire kernels on the CPU, held
against the JAX package: numpy-seeded inputs go through a blocked torch
model of each kernel's route and through ``repro.kernels.ref`` and the
interpreted Pallas kernels; and the launch plan ``kernels/wire_plan.py``,
which decides every launch without a card.

- ``dequant_matmul`` (``csrc/dequant_matmul.cu``): the int8 codes are exact
  in bf16, an f32 w is the exact sum of three bf16 parts, each product
  code x part is exact in f32, the f32 sums run in the kernel's 16-deep
  steps, and the row scale multiplies once after the sum. The reference
  rounds code x scale before each term instead; both sit within the
  unchanged tolerance of ``tests/test_torch_wire_kernels.py``: one bf16
  ulp + 2 N 2^-24 sum_k |z_k w_k| (f32 output: the second term alone).
- ``bottleneck_quant`` (``csrc/bottleneck_quant.cu``): a cluster's blocks
  sum their column tiles over depth slices in staged tiles, the slices
  are added in rank order, the row absmax is the rank-ordered max of the
  blocks' partial maxima; codes may move one step where z / scale sits on
  a rounding edge (under 1% of lanes), scales by rtol 1e-5, and a row of
  zeros gives zero codes and the scale 1e-8 / qmax exactly.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bottleneck_quant import bottleneck_quant as j_bq_kernel
from repro.kernels.dequant_matmul import dequant_matmul as j_dq_kernel
from repro_torch.kernels import wire_plan as WP

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TD[dtype])


def split3(w):
    """An f32 tensor as the kernel stages it: three bf16 parts, each the
    round-to-nearest-even of what the parts before it leave."""
    hi = w.to(torch.bfloat16)
    rem = w - hi.float()
    mid = rem.to(torch.bfloat16)
    rem = rem - mid.float()
    return hi, mid, rem.to(torch.bfloat16)


def _edges(rng, n):
    """f32 values at bf16 rounding edges: exact ties between two bf16
    neighbours and the f32 values one ulp either side of them."""
    top = rng.integers(0x3000, 0x4F00, n).astype(np.uint32) << 16
    tie = top | 0x8000
    vals = np.concatenate([tie, tie + 1, tie - 1]).view(np.float32)
    sign = np.where(rng.random(vals.size) < 0.5, -1, 1).astype(np.float32)
    return vals * sign


@pytest.mark.parametrize("scale", [0.02, 1.0, 1e20, "edges"])
def test_three_part_bf16_split_is_exact(scale):
    """hi + mid + lo, summed in float64, is w bit for bit, and each part is
    a bf16 value. This holds while the last part stays a normal number:
    for |w| near 1e-30 and below, lo = bf16(w - hi - mid) falls under
    bf16's smallest normal (2^-126) and the split drops bits."""
    rng = np.random.default_rng(7)
    if scale == "edges":
        w = torch.from_numpy(_edges(rng, 1 << 14))
    else:
        w = torch.from_numpy((scale * rng.standard_normal(1 << 16)).astype(
            np.float32))
    parts = split3(w)
    total = sum(p.double() for p in parts)
    assert torch.equal(total, w.double())
    for p in parts:
        assert torch.equal(p.float().to(torch.bfloat16).float(), p.float())


def dq_model(codes, scales, w, out_dtype):
    """dequant_matmul's route: codes as bf16 (exact), w as one bf16 part
    or three, f32 sums over 16-deep steps in k order (each part of a step
    in turn), then one multiply by the row scale and one rounding."""
    c = codes.float()
    parts = [w.float()] if w.dtype == torch.bfloat16 else [
        p.float() for p in split3(w)]
    acc = torch.zeros((codes.shape[0], w.shape[1]), dtype=torch.float32)
    for k0 in range(0, codes.shape[1], 16):
        for p in parts:
            acc = acc + c[:, k0:k0 + 16] @ p[k0:k0 + 16]
    return (acc * scales).to(out_dtype)


def _within(y, want, env, bf16_out):
    y = np.asarray(y, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(y - want)
    tol = env
    if bf16_out:
        mag = np.maximum(np.abs(y), np.abs(want))
        tol = tol + np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (err <= tol).all(), (err.max(), int((err > tol).sum()))


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("w_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,D", [(16, 160, 256), (8, 96, 128)])
def test_dequant_matmul_route_matches_jax(M, N, D, w_dtype, out):
    rng = np.random.default_rng(11)
    z = rng.standard_normal((M, N)).astype(np.float32)
    codes, scales = jref.bottleneck_quant_ref(jnp.asarray(z),
                                              jnp.eye(N, dtype=jnp.float32))
    codes, scales = np.array(codes), np.array(scales)
    codes[0, :4] = [127, -127, 127, -127]          # the code range's ends
    w = (0.05 * rng.standard_normal((N, D))).astype(np.float32).astype(
        NP[w_dtype])
    y = dq_model(torch.from_numpy(codes), torch.from_numpy(scales),
                 _t(w, w_dtype), TD[out])
    assert y.dtype == TD[out] and y.shape == (M, D)
    zf = codes.astype(np.float32) * scales
    env = 2 * N * 2.0 ** -24 * (np.abs(zf) @ np.abs(np.asarray(w, np.float32)))
    jdt = jnp.bfloat16 if out == "bfloat16" else jnp.float32
    for want in (jref.dequant_matmul_ref(codes, scales, jnp.asarray(w),
                                         out_dtype=jdt),
                 j_dq_kernel(codes, scales, jnp.asarray(w), out_dtype=jdt,
                             block_m=8, block_d=128, interpret=True)):
        _within(y.float().numpy(), want, env, out == "bfloat16")


def bq_model(x, w, bits, plan):
    """bottleneck_quant's route on ``plan``: each block sums its column
    tiles over its depth slice in staged tiles, k ascending; each rank sums
    its part of its group's columns over the slices in rank order and
    takes its partial row absmax; the row absmax is the max over ranks in
    rank order; then the scale and the codes, as the reference."""
    M, K = x.shape
    N = w.shape[1]
    xf, wf = x.float(), w.float()
    qm = max((1 << (bits - 1)) - 1, 1)
    codes = torch.empty((M, N), dtype=torch.int8)
    scales = torch.empty((M, 1), dtype=torch.float32)
    tiles = {}    # row tile -> (rows, {rank: that block's z, [rows, N]})
    for (tile, rank), rows, cols, ks in WP.blocks(plan, M, K, N):
        zr = torch.zeros((len(rows), N), dtype=torch.float32)
        for cr in cols:
            for k0 in range(ks.start, ks.stop, plan.block_k):
                k1 = min(ks.stop, k0 + plan.block_k)
                zr[:, cr.start:cr.stop] += (
                    xf[rows.start:rows.stop, k0:k1] @ wf[k0:k1,
                                                         cr.start:cr.stop])
        tiles.setdefault(tile, (rows, {}))[1][rank] = zr
    groups, slices = plan.col_groups, plan.cluster // plan.col_groups
    for rows, zr in tiles.values():
        z = torch.zeros((len(rows), N), dtype=torch.float32)
        amax = torch.zeros(len(rows))
        for rank in range(plan.cluster):             # rank order
            part = WP.reduce_part(plan, rank, N)
            cols = slice(part.start, part.stop)
            v = zr[rank % groups][:, cols]
            for t in range(1, slices):               # slices in rank order
                v = v + zr[t * groups + rank % groups][:, cols]
            z[:, cols] = v
            if len(part):
                amax = torch.maximum(amax, torch.amax(v.abs(), dim=1))
        amax = amax[:, None]
        scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, qm)
        codes[rows.start:rows.stop] = torch.clamp(torch.round(z / scale),
                                                  -qm, qm).to(torch.int8)
        scales[rows.start:rows.stop] = scale
    return codes, scales


def _check_codes(codes, want, qmax):
    diff = np.abs(np.asarray(codes, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01
    assert np.abs(np.asarray(codes, np.int32)).max() <= qmax


def _pad(a, rows, cols):
    out = np.zeros((rows, cols), dtype=a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(37, 100, 80), (1, 260, 160),
                                   (37, 300, 160)])
def test_bottleneck_quant_cluster_route_matches_jax(M, K, N, dtype, bits):
    """Ragged rows, a depth that is no multiple of 8, widths that are no
    multiple of 128; planned for a card of 8 SMs, so the depth splits over
    the cluster's ranks. Row 0 is zero."""
    rng = np.random.default_rng(13)
    x = (0.5 * rng.standard_normal((M, K))).astype(np.float32).astype(
        NP[dtype])
    x[0] = 0
    w = (0.02 * rng.standard_normal((K, N))).astype(np.float32).astype(
        NP[dtype])
    plan = WP.wire_plan("bottleneck_quant", M, K, N,
                        bf16=dtype == "bfloat16", n_sms=8, bits=bits)
    assert plan.cluster // plan.col_groups > 1 or K <= plan.block_k
    codes, scales = bq_model(_t(x, dtype), _t(w, dtype), bits, plan)
    qm = max((1 << (bits - 1)) - 1, 1)
    mp, kp = -(-M // 8) * 8, -(-K // 64) * 64     # the Pallas kernel's tiles
    j_ker = j_bq_kernel(jnp.asarray(_pad(x, mp, kp)),
                        jnp.asarray(_pad(w, kp, N)), bits=bits, block_m=8,
                        block_k=64, interpret=True)
    for jc, js in (jref.bottleneck_quant_ref(jnp.asarray(x), jnp.asarray(w),
                                             bits), j_ker):
        _check_codes(codes.numpy(), np.asarray(jc)[:M], qm)
        np.testing.assert_allclose(scales.numpy(), np.asarray(js)[:M],
                                   rtol=1e-5)
    assert not codes[0].any()
    assert float(scales[0, 0]) == np.float32(1e-8) / np.float32(qm)


# the six timed shapes: (op, m, k, n, bf16)
TIMED = [("bottleneck_quant", 512, 2048, 512, False),
         ("bottleneck_quant", 512, 2048, 512, True),
         ("bottleneck_quant", 512, 2560, 640, True),
         ("dequant_matmul", 512, 512, 2048, False),
         ("dequant_matmul", 512, 512, 2048, True),
         ("dequant_matmul", 512, 640, 2560, True)]
COVER = TIMED + [("bottleneck_quant", 37, 2043, 636, True),
                 ("bottleneck_quant", 1, 100, 80, False),
                 ("bottleneck_quant", 64, 256, 4096, True),
                 ("bottleneck_quant", 16, 300, 4096, False),
                 ("dequant_matmul", 37, 636, 2560, True),
                 ("dequant_matmul", 1, 2048, 100, False)]


@pytest.mark.parametrize("n_sms", [132, 114])
@pytest.mark.parametrize("op,m,k,n,bf16", COVER)
def test_wire_plan_covers_every_output_and_depth_once(op, m, k, n, bf16,
                                                      n_sms):
    """Every output element is computed by blocks whose depth ranges
    partition [0, k); for bottleneck_quant each column is reduced and
    quantized by exactly one rank of its cluster. The cluster divides the
    grid and holds at most 8 blocks; shared memory fits a block's 227 KB."""
    plan = WP.wire_plan(op, m, k, n, bf16=bf16, n_sms=n_sms)
    count = np.zeros((m, n), np.int32)
    depth = np.zeros((m, n), np.int64)
    for _, rows, cols, ks in WP.blocks(plan, m, k, n):
        assert ks.start < ks.stop and ks.start % plan.block_k == 0
        for cr in cols:
            count[rows.start:rows.stop, cr.start:cr.stop] += 1
            depth[rows.start:rows.stop, cr.start:cr.stop] += len(ks)
    slices = plan.cluster // plan.col_groups
    assert (count == slices).all() and (depth == k).all()
    if op == "bottleneck_quant":
        owner = np.zeros(n, np.int32)
        for rank in range(plan.cluster):
            part = WP.reduce_part(plan, rank, n)
            owner[part.start:part.stop] += 1
        assert (owner == 1).all()
        assert plan.k_slice % plan.block_k == 0
    assert 1 <= plan.cluster <= WP.MAX_CLUSTER
    assert plan.grid[0] % plan.cluster == 0
    assert plan.smem_bytes <= WP.SMEM_LIMIT


@pytest.mark.parametrize("n_sms", [132, 114])
@pytest.mark.parametrize("op,m,k,n,bf16", TIMED)
def test_wire_plan_gives_every_sm_a_block(op, m, k, n, bf16, n_sms):
    plan = WP.wire_plan(op, m, k, n, bf16=bf16, n_sms=n_sms)
    blocks = plan.grid[0] * (plan.grid[1] if len(plan.grid) > 1 else 1)
    assert blocks >= n_sms
    assert plan.vec_a and plan.vec_b


@pytest.mark.parametrize("op", ["bottleneck_quant", "dequant_matmul"])
def test_wire_plan_takes_the_narrow_copy_off_alignment(op):
    """A base off 16-byte alignment, or rows that are no whole number of
    16-byte chunks, take element loads; aligned rows take 16-byte copies."""
    def plan(k, n, aligned=(True, True), bf16=True):
        return WP.wire_plan(op, 64, k, n, bf16=bf16, n_sms=132,
                            aligned=aligned)
    assert plan(512, 512).vec_a and plan(512, 512).vec_b
    assert not plan(512, 512, aligned=(False, True)).vec_a
    assert not plan(512, 512, aligned=(True, False)).vec_b
    assert not plan(509, 512).vec_a                  # a's rows: k elements
    assert not plan(512, 508).vec_b                  # b's rows: n elements
    assert plan(512, 508, bf16=False).vec_b          # 508 f32: 2032 bytes


@pytest.mark.parametrize("n_sms", [132, 114])
def test_wire_plan_keeps_every_cluster_on_the_card(n_sms):
    """bottleneck_quant launches no more clusters than the card holds at
    once (the card's count comes from the occupancy API; here a toy card
    whose SMs pack fewer of the larger blocks), while every SM still gets a
    block; ties in cost go to the earlier tile and the fewer slices."""
    def held(bn, cluster, smem):
        return (2 * n_sms if smem <= 70000 else n_sms) // cluster
    free = WP.wire_plan("bottleneck_quant", 512, 2560, 640, bf16=True,
                        n_sms=n_sms)
    plan = WP.wire_plan("bottleneck_quant", 512, 2560, 640, bf16=True,
                        n_sms=n_sms, max_clusters=held)
    rows = 512 // WP.BQ_BM
    assert rows > held(free.block_n, free.cluster, free.smem_bytes)
    assert rows <= held(plan.block_n, plan.cluster, plan.smem_bytes)
    assert plan.grid[0] >= n_sms
    cost = -(-plan.grid[0] // n_sms) * plan.col_tiles * plan.k_slice * (
        WP.BQ_BM + plan.block_n)
    for bn, bk, groups, col_tiles, k_slice, cluster in WP.bq_options(
            2560, 640, True):
        if (rows <= held(bn, cluster, WP.bq_smem(bn, bk, True, col_tiles))
                and rows * cluster >= n_sms):
            assert cost <= -(-rows * cluster // n_sms) * col_tiles * \
                k_slice * (WP.BQ_BM + bn)


@pytest.mark.parametrize("op,k,n,bits", [
    ("bottleneck_quant", 64, 4097, 8), ("dequant_matmul", 2049, 64, 8),
    ("bottleneck_quant", 64, 64, 0), ("bottleneck_quant", 64, 64, 9),
    ("bottleneck_quant", 64, 64, 2.0), ("bottleneck_quant", 0, 64, 8),
    ("no_such_op", 64, 64, 8)])
def test_wire_plan_refuses_what_the_kernels_do_not_take(op, k, n, bits):
    with pytest.raises(ValueError):
        WP.wire_plan(op, 16, k, n, bf16=True, n_sms=132, bits=bits)
