"""The mixed-mode bottleneck boundary and the fused decode tail: the two
hand-written CUDA kernels of ``csrc/boundary_mixed.cu`` (replacing the two
Pallas kernels of ``repro/kernels/boundary_mixed.py``), with their plain
PyTorch versions beside them.

Each wrapper takes the plain version for tensors on the CPU and launches
the kernel for CUDA tensors, raising on anything the kernel does not take;
there is no fallback on the card. ``<wrapper>.launches`` counts kernel
launches (CPU calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (boundary_mixed_rows_ref,
                                     decode_tail_grouped_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}
_TAIL_SLAB = 128    # vocab columns per bf16 slab of the tail (kMV in the .cu)
_BR, _KS = 32, 512  # boundary rows a block, K-slice depth (kBR, kKS)
# dynamic shared memory a block may use on Hopper: the card's 232,448 bytes
# less room for the kernels' static arrays (under 1 KB)
_SMEM_MAX = 232448 - 1024


def _fn(name, argtypes):
    if name not in _fns:
        _fns[name] = _build.bind("boundary_mixed", name, argtypes)
    return _fns[name]


def _check_cuda(what, *tensors, dtype=None):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: non-contiguous input {tuple(t.shape)}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")


def _tables(what, G, *tables):
    out = []
    for t in tables:
        if t.shape != (G,):
            raise ValueError(f"{what}: table of shape {tuple(t.shape)}, "
                             f"expected ({G},)")
        out.append(t.to(torch.int32).contiguous())
    return out


def boundary_plan(N: int, d: int, wmax: int, dtype):
    """(mt, shared-memory bytes a block) of the boundary kernels on ``N``
    rows of width ``d`` against a bank ``wmax`` lanes wide: the tile width
    in 16-lane m-tiles. bf16 at more than 32 rows takes the widest of 4, 2
    and 1 whose blocks fit (fewer blocks rebuilding each row's codes);
    fewer rows, and f32, take 1 (every SM on the weights). ``mt`` changes
    which block computes a value, never the value. Raises ``ValueError``
    where no tile fits."""
    esz = 2 if dtype == torch.bfloat16 else 4
    pad, kmax = 16 // esz, -(-wmax // 16) * 16
    for mt in (4, 2, 1) if esz == 2 and N > 32 else (1,):
        t16 = 16 * mt
        red = 4 * 4 * mt * _BR * 16                # f32 quarter sums
        down = esz * (_KS * (t16 + pad) + _BR * (_KS + pad) + _KS)
        up = esz * (kmax * (t16 + pad) + _BR * (kmax + pad))
        smem = red + max(down, up)
        if smem <= _SMEM_MAX:
            return mt, smem
    raise ValueError(f"boundary_mixed_grouped: a bank {wmax} lanes wide "
                     f"needs {smem} bytes of shared memory a block even at "
                     f"one m-tile ({dtype}), over {_SMEM_MAX}")


def tail_plan(d: int, tied: bool, rows: int):
    """(rows_cap, shared-memory bytes a block) of the bf16 tail's logits
    kernel for row blocks of at most ``rows`` real rows: the rows of width
    ``d`` a block keeps beside its 5-stage ring of 64-deep head tiles. 16
    where a block may hold more than 8 real rows and they fit; else 8, a
    half of a row block (each half then streams the head). Never changes a
    value. Raises ``ValueError`` where 8 rows do not fit."""
    # a staged tile, rows padded by 16 bytes: 128 table rows x 64 deep
    # (tied), or 64 head rows x 128 columns
    ring = 5 * 2 * (_TAIL_SLAB * (64 + 8) if tied else 64 * (_TAIL_SLAB + 8))
    for cap in (16, 8) if rows > 8 else (8,):
        smem = 2 * cap * (d + 8) + ring
        if smem <= _SMEM_MAX:
            return cap, smem
    raise ValueError(f"decode_tail_grouped: 8 rows of width {d} beside the "
                     f"head's ring need {smem} bytes of shared memory, over "
                     f"{_SMEM_MAX}")


def boundary_mixed_grouped(x2, mode_idx, seq_len: int, bank, *,
                           dtype=torch.bfloat16):
    """Fused mixed-mode boundary on the rows in place: the port's
    counterpart of the Pallas ``boundary_mixed_grouped``, which takes a
    mode-grouped padded layout; here each block of the kernel finds the
    rows of its mode itself. ``x2``: [N, d] rows, N = B * ``seq_len``; row
    r rides mode ``mode_idx[r // seq_len]`` (``mode_idx``: [B] int32; 0 =
    raw, m >= 1 = head m-1 of ``bank``, the stacked bank of
    ``bottleneck.bank_stack``: ``down_w`` [M, d, wmax], ``up_w`` [M, wmax,
    d], ``norm_scale`` [M, d], int32 ``width`` / ``bits`` [M], read on the
    device). Returns [N, d] in the input order: two launches, no layout."""
    N, d = x2.shape
    if x2.device.type != "cuda":
        return boundary_mixed_rows_ref(
            x2, mode_idx.repeat_interleave(seq_len), bank, dtype)
    what = "boundary_mixed_grouped"
    down_w, up_w, scale = bank["down_w"], bank["up_w"], bank["norm_scale"]
    M, d2, wmax = down_w.shape
    if x2.dtype not in (torch.bfloat16, torch.float32) or dtype != x2.dtype:
        raise TypeError(f"{what}: takes bf16 or f32 rows in the model dtype, "
                        f"got {x2.dtype} / {dtype}")
    bf16 = x2.dtype == torch.bfloat16
    B = mode_idx.shape[0]
    if (d2 != d or d % 8 or wmax % 8 or N == 0 or B * seq_len != N
            or mode_idx.shape != (B,) or mode_idx.dtype != torch.int32
            or up_w.shape != (M, wmax, d) or scale.shape != (M, d)
            or any(t.data_ptr() % 16 for t in (x2, down_w, up_w, scale))):
        raise ValueError(f"{what}: unsupported shapes x {tuple(x2.shape)} "
                         f"modes {tuple(mode_idx.shape)} {mode_idx.dtype} "
                         f"seq_len {seq_len} down {tuple(down_w.shape)} "
                         f"up {tuple(up_w.shape)}")
    mt, smem = boundary_plan(N, d, wmax, x2.dtype)
    _check_cuda(what, x2, down_w, up_w, scale, dtype=x2.dtype)
    width, bits = _tables(what, M, bank["width"], bank["bits"])
    _check_cuda(what, x2, mode_idx, width, bits)
    out = torch.empty_like(x2)
    partial = torch.empty((-(-d // _KS), N, wmax), dtype=torch.float32,
                          device=x2.device)
    fn = _fn("boundary_mixed_rows_launch",
             [_P, _P, _I, _I] + [_P] * 5 + [_I, _P, _P] + [_I] * 4 + [_P])
    code = fn(x2.data_ptr(), mode_idx.data_ptr(), B, seq_len,
              down_w.data_ptr(), up_w.data_ptr(), scale.data_ptr(),
              width.data_ptr(), bits.data_ptr(), M, partial.data_ptr(),
              out.data_ptr(), d, wmax, mt, int(bf16),
              _build.stream_ptr(x2.device))
    _build.check(code, what)
    boundary_mixed_grouped.launches += 1
    boundary_mixed_grouped.last_plan = {"rows": N, "mt": mt, "smem": smem}
    return out


boundary_mixed_grouped.launches = 0
boundary_mixed_grouped.last_plan = None


def decode_tail_grouped(xp, heads, norm_scale, norm_bias=None, hid_g=None, *,
                        block_r: int, norm_kind: str = "rmsnorm",
                        n_blocks=None, tied: bool = False, n_real=None,
                        rows_g=None):
    """Fused decode tail: final norm -> per-block LM head -> argmax -> int32
    token. ``xp``: [P, d] rows in blocks of ``block_r``; ``heads``: [H, d,
    V], or with ``tied`` the embedding table as [H, V, d], read in place;
    ``norm_scale``: [d]; ``norm_bias``: [d] or None; ``hid_g``: the head of
    each block, [ceil(P / block_r)] int32 (``ops.head_layout``), or None for
    head 0. ``n_blocks``: compute only the first row blocks (rows past them
    are returned as 0), default all. With one head the rows are read in
    place: P need not be a multiple of ``block_r``. The real rows, the only
    ones the kernel reads: the first ``n_real`` (default every row of the
    computed blocks; rows at or past it return 0), or per block ``rows_g``
    [P / block_r] int32 on the device (``ops.head_rows``; the bf16 kernel
    computes only those, the other rows of a block return 0). Returns [P]
    int32 tokens."""
    P, d = xp.shape
    if tied:
        H, V, d2 = heads.shape
    else:
        H, d2, V = heads.shape
    G = -(-P // block_r)
    n_run = G if n_blocks is None else int(n_blocks)
    if xp.device.type != "cuda":
        block_v = next((b for b in (512, 256, 128) if V % b == 0), V)
        hv = heads.transpose(1, 2) if tied else heads        # a view
        pad = G * block_r - P
        x_all = torch.cat([xp, xp.new_zeros((pad, d))]) if pad else xp
        hid = torch.zeros(G, dtype=torch.int32) if hid_g is None else hid_g
        tok = decode_tail_grouped_ref(x_all, hv, norm_scale, norm_bias, hid,
                                      block_r=block_r, block_v=block_v,
                                      norm_kind=norm_kind)[:P, 0].clone()
        tok[n_run * block_r:] = 0
        return tok
    what = "decode_tail_grouped"
    if xp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: takes bf16 or f32 rows, got {xp.dtype}")
    bf16 = xp.dtype == torch.bfloat16
    r_kernel = 16 if bf16 else 8
    # bf16: 64-deep tiles of 16-byte copies; f32: a tied row is read in
    # 32-byte sectors from a 16-byte aligned start
    shape_ok = (d % 64 == 0 and V % 8 == 0) if bf16 \
        else (not tied or d % 8 == 0)
    # rows normed and reduced: with per-block counts every row of the
    # computed blocks (a padded layout), else the first n_real rows
    rows = n_run * block_r if rows_g is not None else min(n_run * block_r, P)
    n_real = rows if n_real is None or rows_g is not None else int(n_real)
    if (block_r != r_kernel or d2 != d or not 0 < n_run <= G
            or not 0 < n_real <= rows or rows > P
            or norm_scale.shape != (d,)
            or (norm_bias is not None and norm_bias.shape != (d,))
            or norm_kind not in ("rmsnorm", "layernorm") or not shape_ok
            or heads.data_ptr() % 16):
        raise ValueError(f"{what}: unsupported shapes xp {tuple(xp.shape)} "
                         f"heads {tuple(heads.shape)} tied {tied} block_r "
                         f"{block_r} n_blocks {n_run} n_real {n_real} norm "
                         f"{norm_kind}")
    vecs = [xp, heads, norm_scale] + ([] if norm_bias is None
                                      else [norm_bias])
    _check_cuda(what, *vecs, dtype=xp.dtype)
    hid = None if hid_g is None else _tables(what, G, hid_g)[0]
    if rows_g is not None:
        (rows_g,) = _tables(what, G, rows_g)
    rows_cap = 0
    if bf16:
        rows_cap = tail_plan(
            d, tied, 16 if rows_g is not None else min(n_real, 16))[0]
    ld = -(-V // _TAIL_SLAB)
    hbuf = torch.empty((n_real, d), dtype=xp.dtype, device=xp.device)
    pbest = torch.empty((n_run * block_r, ld), dtype=torch.float32,
                        device=xp.device)
    pidx = torch.empty((n_run * block_r, ld), dtype=torch.int32,
                       device=xp.device)
    # every row written when the real rows are all of them: no memset
    tok = (torch.empty if n_real == P else torch.zeros)(
        P, dtype=torch.int32, device=xp.device)
    fn = _fn("decode_tail_grouped_launch",
             [_P] * 9 + [_I] * 6 + [_P] + [_I] * 3 + [_P])

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = fn(xp.data_ptr(), heads.data_ptr(), norm_scale.data_ptr(),
              ptr(norm_bias), ptr(hid), hbuf.data_ptr(), pbest.data_ptr(),
              pidx.data_ptr(), tok.data_ptr(), n_run, d, V,
              int(norm_kind == "layernorm"), int(tied), int(bf16),
              ptr(rows_g), n_real, ld, rows_cap, _build.stream_ptr(xp.device))
    _build.check(code, what)
    decode_tail_grouped.launches += 1
    decode_tail_grouped.last_plan = {"rows_cap": rows_cap}
    return tok


decode_tail_grouped.launches = 0
decode_tail_grouped.last_plan = None
