"""The launch plan of the two wire kernels, ``csrc/bottleneck_quant.cu`` and
``csrc/dequant_matmul.cu``: tile sizes, cluster, grid, shared memory and
copy form, decided in Python from the shapes, the dtypes, the operands'
alignment, the card's SM count and, for ``bottleneck_quant``, how many of
its clusters the card holds at once. Nothing here needs a card (the
wrappers pass the card's counts in); the kernels check that the plan's
shared memory equals their own layout.

Both kernels compute a product ``a [m, k] @ b [k, n]``: for
``bottleneck_quant`` a is x and b the down-projection (n = N, the wire
width); for ``dequant_matmul`` a is the codes (k = N, the wire width) and
b the up-projection (n = D).
"""
from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional, Tuple

BQ_STAGES = 3            # cp.async ring depths (kStages of each kernel)
DQ_STAGES = 3
SMEM_LIMIT = 232448      # dynamic shared memory a block may take (227 KB)
SMEM_SM = 233472         # shared memory of an SM (228 KB), 1 KB a block kept
MAX_CLUSTER = 8          # portable cluster size
BQ_MAX_N = 4096          # bottleneck_quant: columns of z
DQ_MAX_K = 2048          # dequant_matmul: the code width N
BQ_BM = 16               # bottleneck_quant: a block's rows
# its (column tile, staged depth) choices, by bf16
BQ_TILES = {True: ((128, 64), (256, 32), (320, 32)), False: ((256, 16),)}
DQ_BK = 64
# dequant_matmul's output tiles, largest first
DQ_TILES = ((64, 128), (64, 64), (32, 64), (16, 64))


class WirePlan(NamedTuple):
    """How one wire kernel covers ``a [m, k] @ b [k, n]``.

    A block computes ``block_m`` rows. For ``dequant_matmul`` it owns one
    ``block_m x block_n`` output tile and the whole depth; ``grid`` is
    (row tiles, column tiles). For ``bottleneck_quant`` a cluster of
    ``cluster`` blocks owns one row tile and all n columns: rank r takes
    column group r % ``col_groups`` (``col_tiles`` tiles of ``block_n``,
    walked in turn) and depth slice r // ``col_groups`` (``k_slice`` deep,
    a multiple of ``block_k``); ``grid`` is (row tiles * cluster,).
    ``smem_bytes`` is the block's dynamic shared memory; ``vec_a`` /
    ``vec_b`` choose 16-byte copies of a / b (False: element loads)."""
    op: str
    block_m: int
    block_n: int
    block_k: int
    col_groups: int
    col_tiles: int
    k_slice: int
    cluster: int
    grid: Tuple[int, ...]
    smem_bytes: int
    vec_a: bool
    vec_b: bool


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _vec(aligned: bool, row_elems: int, elem_bytes: int) -> bool:
    """16-byte copies need a 16-byte aligned base and rows of whole
    16-byte chunks."""
    return aligned and (row_elems * elem_bytes) % 16 == 0


def bq_smem(bn: int, bk: int, bf16: bool, col_tiles: int) -> int:
    """bottleneck_quant's dynamic shared memory: the ring (x and w tiles)
    and the block's f32 z tiles."""
    stage = (BQ_BM * bk + bk * bn) * (2 if bf16 else 4)
    return BQ_STAGES * stage + BQ_BM * col_tiles * bn * 4


def dq_smem(bm: int, bn: int, bf16: bool) -> int:
    """dequant_matmul's shared memory: the ring (codes and raw w tiles),
    the widened codes and, for an f32 w, its three bf16 parts."""
    raw = DQ_BK * bn * (2 if bf16 else 4)
    split = 0 if bf16 else 3 * DQ_BK * bn * 2
    return DQ_STAGES * (bm * DQ_BK + raw) + bm * DQ_BK * 2 + split


def bq_options(k: int, n: int, bf16: bool) -> list:
    """bottleneck_quant's launches for depth k and n columns, as (column
    tile, staged depth, column groups, column tiles a block, depth of a
    slice, cluster): each tile width, cut into at most MAX_CLUSTER groups,
    with each depth split the rest of the cluster allows."""
    options = []
    for bn, bk in BQ_TILES[bf16]:
        n_ct = _cdiv(n, bn)
        col_tiles = _cdiv(n_ct, MAX_CLUSTER)
        groups = _cdiv(n_ct, col_tiles)
        nk = _cdiv(k, bk)
        for s in range(1, min(MAX_CLUSTER // groups, nk) + 1):
            k_slice = _cdiv(nk, s) * bk
            slices = _cdiv(k, k_slice)             # no empty slice
            options.append((bn, bk, groups, col_tiles, k_slice,
                            groups * slices))
    return options


def resident_clusters(n_sms: int, cluster: int, smem: int) -> int:
    """Clusters of ``cluster`` blocks the card holds at once, counted from
    shared memory alone (the card's own count, from the occupancy API,
    also knows how SMs group into GPCs, and is what the wrapper uses)."""
    return n_sms * (SMEM_SM // (smem + 1024)) // cluster


def wire_plan(op: str, m: int, k: int, n: int, *, bf16: bool, n_sms: int,
              aligned: Tuple[bool, bool] = (True, True), bits: int = 8,
              max_clusters: Optional[Callable[[int, int, int], int]] = None
              ) -> WirePlan:
    """The plan of ``op`` ("bottleneck_quant" or "dequant_matmul") for
    ``a [m, k] @ b [k, n]`` on a card of ``n_sms`` SMs. ``bf16``: x and w
    are bf16 (bottleneck_quant), w is bf16 (dequant_matmul); ``aligned``:
    a's and b's base pointers are 16-byte aligned; ``max_clusters(block_n,
    cluster, smem_bytes)``: the clusters of bottleneck_quant the card holds
    at once (by default ``resident_clusters``). Among the launches that give
    every SM a block (where none does, the one with the most blocks) and,
    for bottleneck_quant, whose clusters all fit on the card at once,
    bottleneck_quant takes the tile and depth split and dequant_matmul the
    output tile that streams the fewest bytes an SM. Raises on a shape the
    kernel does not take."""
    if min(m, k, n) < 1:
        raise ValueError(f"{op}: shape [{m}, {k}] x [{k}, {n}] not taken")
    if op == "bottleneck_quant":
        if n > BQ_MAX_N:
            raise ValueError(f"{op}: takes N <= {BQ_MAX_N}, got {n}")
        if not isinstance(bits, int) or not 1 <= bits <= 8:
            raise ValueError(f"{op}: bits {bits!r} outside 1..8")
        es, rows = (2 if bf16 else 4), _cdiv(m, BQ_BM)
        options = bq_options(k, n, bf16)
        held = max_clusters or (lambda bn, cl, smem: resident_clusters(
            n_sms, cl, smem))
        at_once = [o for o in options if rows <= held(
            o[0], o[5], bq_smem(o[0], o[1], bf16, o[3]))] or options
        fit = [o for o in at_once if rows * o[5] >= n_sms]
        # the tile and depth split with the fewest bytes an SM streams
        # (waves of blocks x a block's x and w tiles); ties to the earlier
        # tile and fewer slices
        bn, bk, groups, col_tiles, k_slice, cluster = min(
            fit or [max(at_once, key=lambda o: o[5])],
            key=lambda o: _cdiv(rows * o[5], n_sms) * o[3] * o[4]
            * (BQ_BM + o[0]))
        return WirePlan(op, BQ_BM, bn, bk, groups, col_tiles, k_slice,
                        cluster, (rows * cluster,),
                        bq_smem(bn, bk, bf16, col_tiles),
                        _vec(aligned[0], k, es), _vec(aligned[1], n, es))
    if op == "dequant_matmul":
        if k > DQ_MAX_K:
            raise ValueError(f"{op}: takes N <= {DQ_MAX_K}, got {k}")
        # the fewest bytes an SM streams (waves of blocks x a block's codes
        # and w) among the tiles that give every SM a block; ties to the
        # larger tile
        es = 2 if bf16 else 4
        grids = {t: _cdiv(m, t[0]) * _cdiv(n, t[1]) for t in DQ_TILES}
        fit = [t for t in DQ_TILES if grids[t] >= n_sms] or [DQ_TILES[-1]]
        bm, bn = min(fit, key=lambda t: _cdiv(grids[t], n_sms)
                     * (t[0] + t[1] * es))
        return WirePlan(op, bm, bn, DQ_BK, 1, 1, _cdiv(k, DQ_BK) * DQ_BK, 1,
                        (_cdiv(m, bm), _cdiv(n, bn)), dq_smem(bm, bn, bf16),
                        _vec(aligned[0], k, 1),
                        _vec(aligned[1], n, 2 if bf16 else 4))
    raise ValueError(f"unknown wire op {op!r}")


def blocks(plan: WirePlan, m: int, k: int, n: int
           ) -> Iterator[Tuple[int, range, list, range]]:
    """Each block's work as the kernel indexes it: (block, its rows, its
    column ranges, its depth range), rows and columns cut at m and n. For
    bottleneck_quant the block is (row tile, cluster rank)."""
    if plan.op == "dequant_matmul":
        for bx in range(plan.grid[0]):
            for by in range(plan.grid[1]):
                r0, c0 = bx * plan.block_m, by * plan.block_n
                yield ((bx, by), range(r0, min(m, r0 + plan.block_m)),
                       [range(c0, min(n, c0 + plan.block_n))], range(0, k))
        return
    width = plan.col_tiles * plan.block_n
    for b in range(plan.grid[0]):
        rank = b % plan.cluster
        g, s = rank % plan.col_groups, rank // plan.col_groups
        r0 = b // plan.cluster * plan.block_m
        cols = [range(c0, min(n, c0 + plan.block_n))
                for c0 in range(g * width, min(n, (g + 1) * width),
                                plan.block_n)]
        yield ((b // plan.cluster, rank),
               range(r0, min(m, r0 + plan.block_m)), cols,
               range(s * plan.k_slice, min(k, (s + 1) * plan.k_slice)))


def reduce_part(plan: WirePlan, rank: int, n: int) -> range:
    """The columns (of all n) whose depth slices bottleneck_quant's block
    ``rank`` sums, takes the absmax of and quantizes: one part of its
    column group, 4-column aligned."""
    width = plan.col_tiles * plan.block_n
    slices = plan.cluster // plan.col_groups
    g, s = rank % plan.col_groups, rank // plan.col_groups
    sub = _cdiv(_cdiv(width, slices), 4) * 4
    lo = min(width, s * sub)
    hi = min(width, lo + sub, n - g * width)
    return range(g * width + lo, g * width + max(lo, hi))
