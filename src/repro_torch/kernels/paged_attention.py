"""Paged decode attention: the hand-written CUDA kernel of
``csrc/paged_attention.cu`` (replacing the Pallas kernel of
``repro/kernels/paged_attention.py``), with its plain PyTorch version
beside it. CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. ``paged_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None


def paged_attention(q, k_pages, v_pages, block_table, positions):
    """One-token GQA decode attention through a block table.

    q: [B, nq, hd] (rope applied); ``k_pages``/``v_pages``:
    [n_pages, page_len, n_kv, hd] with the current token's row written;
    ``block_table``: [B, nb] arena page ids (every id a valid page — the
    pool points unallocated entries at scratch page 0); ``positions``: [B].
    Returns the attention context [B, nq, hd] in ``q.dtype``."""
    global _fn
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   positions)
    what = "paged_attention"
    B, nq, hd = q.shape
    n_pages, plen, n_kv, hd2 = k_pages.shape
    nb = block_table.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: takes bf16 or f32, got {q.dtype}")
    if (hd2 != hd or hd % 32 or hd > 1024 or nq % n_kv or nq // n_kv > 16
            or v_pages.shape != k_pages.shape
            or block_table.shape[0] != B or positions.shape != (B,)):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)} "
                         f"pages {tuple(k_pages.shape)} table "
                         f"{tuple(block_table.shape)}")
    for t in (q, k_pages, v_pages):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{what}: q/k/v must share device and dtype "
                             f"and be contiguous")
    bt = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    pos = positions.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    if _fn is None:
        _fn = _build.bind("paged_attention", "paged_attention_launch",
                          [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _P])
    code = _fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               bt.data_ptr(), pos.data_ptr(), out.data_ptr(), B, nq, n_kv, hd,
               plen, nb, 1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
               _build.stream_ptr(q.device))
    _build.check(code, what)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
