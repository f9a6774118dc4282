"""Paged decode attention: the hand-written CUDA kernels of
``csrc/paged_attention.cu`` (replacing the Pallas kernel of
``repro/kernels/paged_attention.py``), with their plain PyTorch version
beside them. CPU tensors take the plain version; CUDA tensors launch the
kernels or raise. ``paged_attention.launches`` counts calls that launched
(one launch in the one-range form, three in the split form).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None
_sms = {}

ONE_RANGE_PAGES = 16    # tables this wide run as one range: one launch


def pages_per_split_for(B: int, n_kv: int, nb: int, n_sms: int) -> int:
    """Pages per range of the split form, from shapes the host knows (the
    positions stay on the device). A table of at most ``ONE_RANGE_PAGES``
    pages is one range. A wider one is cut so that B * n_kv * ranges is
    about two blocks an SM were every sequence full, at least 4 pages a
    range; ranges past a sequence's position exit at once."""
    if nb <= ONE_RANGE_PAGES:
        return nb
    ranges = -(-2 * n_sms // (B * n_kv))
    return max(4, -(-nb // ranges))


def paged_attention(q, k_pages, v_pages, block_table, positions, *,
                    pages_per_split=None):
    """One-token GQA decode attention through a block table.

    q: [B, nq, hd] (rope applied); ``k_pages``/``v_pages``:
    [n_pages, page_len, n_kv, hd] with the current token's row written;
    ``block_table``: [B, nb] arena page ids (every id a valid page — the
    pool points unallocated entries at scratch page 0); ``positions``: [B].
    ``pages_per_split``: pages per range on the card (>= nb: one range);
    None picks it (``pages_per_split_for``). Every choice gives the same
    numbers. Returns the attention context [B, nq, hd] in ``q.dtype``."""
    global _fn
    if q.device.type != "cuda":
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   positions)
    what = "paged_attention"
    B, nq, hd = q.shape
    n_pages, plen, n_kv, hd2 = k_pages.shape
    nb = block_table.shape[1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: takes bf16 or f32, got {q.dtype}")
    if (hd2 != hd or hd % 16 or hd > 256 or nq % n_kv or nq // n_kv > 16
            or v_pages.shape != k_pages.shape
            or block_table.shape[0] != B or positions.shape != (B,)):
        raise ValueError(f"{what}: unsupported shapes q {tuple(q.shape)} "
                         f"pages {tuple(k_pages.shape)} table "
                         f"{tuple(block_table.shape)}")
    for t in (q, k_pages, v_pages):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: q/k/v must share device and dtype "
                             f"and be contiguous and 16-byte aligned")
    if pages_per_split is None:
        if q.device not in _sms:
            _sms[q.device] = torch.cuda.get_device_properties(
                q.device).multi_processor_count
        pages_per_split = pages_per_split_for(B, n_kv, nb, _sms[q.device])
    pps = int(pages_per_split)
    if pps < 1:
        raise ValueError(f"{what}: pages_per_split {pps} < 1")
    bt = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    pos = positions.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    scratch = [None] * 5
    if pps < nb:                   # split form: the phases' scratch
        g = nq // n_kv
        f32 = dict(dtype=torch.float32, device=q.device)
        scratch = [
            torch.empty((B, n_kv, g, nb * plen), dtype=q.dtype,
                        device=q.device),                   # scores
            torch.empty((B, n_kv, g, nb), **f32),           # page maxima
            torch.empty((B, n_kv, g, nb), **f32),           # corr
            torch.empty((B, n_kv, g, nb), **f32),           # psum
            torch.empty((B, n_kv, nb, g, hd), dtype=q.dtype,
                        device=q.device)]                   # pv
    if _fn is None:
        _fn = _build.bind("paged_attention", "paged_attention_launch",
                          [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _I]
                          + [_P] * 6)
    code = _fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               bt.data_ptr(), pos.data_ptr(), out.data_ptr(), B, nq, n_kv, hd,
               plen, nb, 1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
               pps, *[None if s is None else s.data_ptr() for s in scratch],
               _build.stream_ptr(q.device))
    _build.check(code, what)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
