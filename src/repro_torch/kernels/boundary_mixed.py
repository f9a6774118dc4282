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
from repro_torch.kernels.ref import (boundary_mixed_grouped_ref,
                                     decode_tail_grouped_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}
_TAIL_SLAB = 128    # vocab columns per bf16 slab of the tail (kMV in the .cu)


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


def boundary_mixed_grouped(xp, down_w, up_w, norm_scale, hid_g, nchunk_g,
                           width_g, bits_g, *, block_r: int,
                           block_w: int = 128, dtype=torch.bfloat16):
    """Mode-grouped fused boundary. ``xp``: [P, d] rows permuted so each
    ``block_r``-row block is mode-uniform (``ops.group_layout``);
    ``down_w``/``up_w``/``norm_scale``: the stacked bank ([M, d, wmax] /
    [M, wmax, d] / [M, d]); per-block int32 tables ``hid_g``, ``nchunk_g``
    (0 = raw passthrough), ``width_g``, ``bits_g``. Returns [P, d]."""
    P, d = xp.shape
    M, d2, wmax = down_w.shape
    if xp.device.type == "cpu":
        return boundary_mixed_grouped_ref(
            xp, down_w, up_w, norm_scale, hid_g, nchunk_g, width_g, bits_g,
            block_r=block_r, block_w=block_w, dtype=dtype)
    what = "boundary_mixed_grouped"
    if xp.dtype not in (torch.bfloat16, torch.float32) or dtype != xp.dtype:
        raise TypeError(f"{what}: takes bf16 or f32 rows in the model dtype, "
                        f"got {xp.dtype} / {dtype}")
    r_kernel = 16 if xp.dtype == torch.bfloat16 else 8
    if (block_r != r_kernel or block_w != 128 or d2 != d or P % block_r
            or up_w.shape != (M, wmax, d) or norm_scale.shape != (M, d)):
        raise ValueError(f"{what}: unsupported shapes xp {tuple(xp.shape)} "
                         f"down {tuple(down_w.shape)} up {tuple(up_w.shape)} "
                         f"block_r {block_r} block_w {block_w}")
    _check_cuda(what, xp, down_w, up_w, norm_scale, dtype=xp.dtype)
    G = P // block_r
    hid, nch, wid, bits = _tables(what, G, hid_g, nchunk_g, width_g, bits_g)
    n_ks = max(1, min(16, d // 128))        # K slices of the down-projection
    out = torch.empty_like(xp)
    inv = torch.empty(P, dtype=torch.float32, device=xp.device)
    partial = torch.empty((n_ks, P, wmax), dtype=torch.float32,
                          device=xp.device)
    wired = torch.empty((P, wmax), dtype=xp.dtype, device=xp.device)
    fn = _fn("boundary_mixed_grouped_launch", [_P] * 12 + [_I] * 5 + [_P])
    code = fn(xp.data_ptr(), down_w.data_ptr(), up_w.data_ptr(),
              norm_scale.data_ptr(), hid.data_ptr(), nch.data_ptr(),
              wid.data_ptr(), bits.data_ptr(), out.data_ptr(), inv.data_ptr(),
              partial.data_ptr(), wired.data_ptr(), P, d, wmax, n_ks,
              int(xp.dtype == torch.bfloat16), _build.stream_ptr(xp.device))
    _build.check(code, what)
    boundary_mixed_grouped.launches += 1
    return out


boundary_mixed_grouped.launches = 0


def decode_tail_grouped(xp, heads, norm_scale, norm_bias, hid_g, *,
                        block_r: int, norm_kind: str = "rmsnorm",
                        n_blocks=None, tied: bool = False, n_real=None,
                        rows_g=None):
    """Fused decode tail: final norm -> per-block LM head -> argmax -> int32
    token. ``xp``: [P, d] rows permuted so each ``block_r``-row block is
    head-uniform (``ops.head_layout``); ``heads``: [H, d, V], or with
    ``tied`` the embedding table as [H, V, d], read in place;
    ``norm_scale``/``norm_bias``: [d]; ``hid_g``: [P/block_r] int32.
    ``n_blocks``: compute only the first row blocks (rows past them are
    returned as 0), default all. The real rows of each block (the bf16
    kernel computes only those): ``rows_g`` [P/block_r] int32 on the device
    (``ops.head_rows``), or the first ``n_real`` rows of the layout, default
    every row; in bf16 the other rows of a computed block return 0.
    Returns [P] int32 tokens."""
    P, d = xp.shape
    if tied:
        H, V, d2 = heads.shape
    else:
        H, d2, V = heads.shape
    G = P // block_r
    n_run = G if n_blocks is None else int(n_blocks)
    if xp.device.type == "cpu":
        block_v = next((b for b in (512, 256, 128) if V % b == 0), V)
        hv = heads.transpose(1, 2) if tied else heads        # a view
        tok = decode_tail_grouped_ref(xp, hv, norm_scale, norm_bias, hid_g,
                                      block_r=block_r, block_v=block_v,
                                      norm_kind=norm_kind)[:, 0].clone()
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
    if (block_r != r_kernel or d2 != d or P % block_r or not 0 < n_run <= G
            or norm_scale.shape != (d,) or norm_bias.shape != (d,)
            or norm_kind not in ("rmsnorm", "layernorm") or not shape_ok
            or heads.data_ptr() % 16):
        raise ValueError(f"{what}: unsupported shapes xp {tuple(xp.shape)} "
                         f"heads {tuple(heads.shape)} tied {tied} block_r "
                         f"{block_r} n_blocks {n_run} norm {norm_kind}")
    _check_cuda(what, xp, heads, norm_scale, norm_bias, dtype=xp.dtype)
    (hid,) = _tables(what, G, hid_g)
    if rows_g is not None:
        (rows_g,) = _tables(what, G, rows_g)
    rows = n_run * block_r
    n_real = rows if n_real is None else int(n_real)
    ld = -(-V // _TAIL_SLAB)
    hbuf = torch.empty((rows, d), dtype=xp.dtype, device=xp.device)
    pbest = torch.empty((rows, ld), dtype=torch.float32, device=xp.device)
    pidx = torch.empty((rows, ld), dtype=torch.int32, device=xp.device)
    tok = torch.zeros(P, dtype=torch.int32, device=xp.device)
    fn = _fn("decode_tail_grouped_launch",
             [_P] * 9 + [_I] * 6 + [_P, _I, _I, _P])
    code = fn(xp.data_ptr(), heads.data_ptr(), norm_scale.data_ptr(),
              norm_bias.data_ptr(), hid.data_ptr(), hbuf.data_ptr(),
              pbest.data_ptr(), pidx.data_ptr(), tok.data_ptr(), n_run, d, V,
              int(norm_kind == "layernorm"), int(tied), int(bf16),
              None if rows_g is None else rows_g.data_ptr(), n_real, ld,
              _build.stream_ptr(xp.device))
    _build.check(code, what)
    decode_tail_grouped.launches += 1
    return tok


decode_tail_grouped.launches = 0
