"""Dispatchers for the hand-written kernels (mirrors ``repro.kernels.ops``).

A CPU tensor takes the plain PyTorch path the reference takes off a TPU
(the serving references of ``kernels.ref``); a CUDA tensor takes the
kernel, whose wrapper raises on a shape or type it does not take. Nothing
falls back on the card. The row layouts (``group_layout`` /
``head_layout``) are computed on the tensors' device without a host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.boundary_mixed import (boundary_mixed_grouped,
                                                decode_tail_grouped)
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.rglru_scan import rglru_scan


def _group_rows(mode_idx, n_modes: int, block_r: int):
    """Mode-uniform row-block layout: rows are stably sorted by mode and
    each mode's run is padded up to a multiple of ``block_r``. Returns
    (dest [B] — each row's slot in the padded layout, starts [n_modes] —
    each mode's padded offset, padded [n_modes], static padded row count
    P = (ceil(B / block_r) + n_modes) * block_r)."""
    B = mode_idx.shape[0]
    dev = mode_idx.device
    m = mode_idx.long()
    order = torch.argsort(m, stable=True)
    counts = torch.zeros(n_modes, dtype=torch.long, device=dev).index_add_(
        0, m, torch.ones(B, dtype=torch.long, device=dev))
    padded = ((counts + block_r - 1) // block_r) * block_r
    starts = torch.cumsum(padded, 0) - padded          # exclusive cumsum
    cum = torch.cumsum(counts, 0) - counts
    sortedm = m[order]
    rank = torch.arange(B, device=dev) - cum[sortedm]
    dest = torch.empty(B, dtype=torch.long, device=dev)
    dest[order] = starts[sortedm] + rank
    P = (-(-B // block_r) + n_modes) * block_r
    return dest, starts, padded, P


def group_layout(stacked, rmode, block_r: int, block_w: int):
    """Row permutation + per-block tables for the grouped boundary kernel.
    ``rmode``: [rows] mode per row. Returns (dest [rows], tables) with the
    static padded row count ``P`` and per-row-block int32 ``hid``,
    ``nchunk`` (0 = raw passthrough), ``width`` and ``bits``. Blocks past
    the used span behave as raw rows and are never gathered back."""
    M = stacked["width"].shape[0]
    dest, starts, padded, P = _group_rows(rmode, M + 1, block_r)
    G = P // block_r
    bstart = torch.arange(G, device=rmode.device) * block_r
    used = bstart < padded.sum()
    bmode = torch.clamp(torch.searchsorted(starts, bstart, right=True) - 1,
                        0, M)
    bmode = torch.where(used, bmode, 0)
    hid_g = torch.clamp(bmode - 1, 0, M - 1)
    width_g = torch.where(bmode >= 1, stacked["width"][hid_g].long(), 0)
    bits_g = torch.where(bmode >= 1, stacked["bits"][hid_g].long(), 0)
    nchunk_g = (width_g + block_w - 1) // block_w
    i32 = torch.int32
    return dest, {"P": P, "hid": hid_g.to(i32), "nchunk": nchunk_g.to(i32),
                  "width": width_g.to(i32), "bits": bits_g.to(i32)}


def head_layout(head_idx, n_heads: int, block_r: int):
    """Head-uniform row-block layout for the fused decode tail. Returns
    (dest [rows], hid_g [P/block_r] int32, static padded row count P).
    Blocks past the used span read head 0 and are never gathered back."""
    dest, starts, padded, P = _group_rows(head_idx, n_heads, block_r)
    G = P // block_r
    bstart = torch.arange(G, device=head_idx.device) * block_r
    used = bstart < padded.sum()
    hid_g = torch.clamp(torch.searchsorted(starts, bstart, right=True) - 1,
                        0, n_heads - 1)
    return dest, torch.where(used, hid_g, 0).to(torch.int32), P


def _block_r(x) -> int:
    return 16 if x.element_size() == 2 else 8


def boundary_mixed_op(stacked, x, mode_idx, *, dtype=torch.bfloat16):
    """Fused mixed-mode bottleneck boundary. x: [B, S, d], ``mode_idx``:
    [B] in [0, M]. CPU: the serving reference; CUDA: the grouped kernel on
    the mode-grouped layout."""
    if x.device.type == "cpu":
        return ref.boundary_mixed_ref(stacked, x, mode_idx, dtype=dtype)
    B, S, d = x.shape
    block_r = _block_r(x)
    rmode = mode_idx.to(torch.int32).repeat_interleave(S)   # per-token mode
    dest, tb = group_layout(stacked, rmode, block_r, 128)
    xp = torch.zeros((tb["P"], d), dtype=x.dtype, device=x.device)
    xp[dest] = x.reshape(B * S, d)
    yp = boundary_mixed_grouped(
        xp, stacked["down_w"], stacked["up_w"], stacked["norm_scale"],
        tb["hid"], tb["nchunk"], tb["width"], tb["bits"], block_r=block_r,
        block_w=128, dtype=dtype)
    return yp[dest].reshape(B, S, d)


def decode_tail_op(x, norm_scale, norm_bias, heads, head_idx=None, *,
                   norm_kind: str = "rmsnorm", tied: bool = False):
    """Fused decode tail: final norm -> LM head -> argmax -> int32 tokens
    [B, S]. ``heads``: [H, d, V] stacked LM heads, or the [1, V, d]
    embedding table when ``tied`` (read in place by the kernel, never
    copied). CPU: the serving reference; CUDA: the fused tail kernel."""
    if x.device.type == "cpu":
        return ref.decode_tail_ref(x, norm_scale, norm_bias, heads, head_idx,
                                   norm_kind=norm_kind, tied=tied)
    B, S, d = x.shape
    H = heads.shape[0]
    hidx = torch.zeros(B, dtype=torch.int32, device=x.device) \
        if head_idx is None else head_idx.to(torch.int32)
    rhid = hidx.repeat_interleave(S)                       # per-token head
    block_r = _block_r(x)
    dest, hid_g, P = head_layout(rhid, H, block_r)
    xp = torch.zeros((P, d), dtype=x.dtype, device=x.device)
    xp[dest] = x.reshape(B * S, d)
    bias = norm_bias if norm_bias is not None else torch.zeros_like(norm_scale)
    # one head: the rows sit in the first ceil(rows / block_r) blocks, and
    # the padding block behind them is never read back
    n_blocks = -(-(B * S) // block_r) if H == 1 else None
    tok = decode_tail_grouped(xp, heads, norm_scale, bias, hid_g,
                              block_r=block_r, norm_kind=norm_kind,
                              n_blocks=n_blocks, tied=tied)
    return tok[dest].reshape(B, S)


def paged_attention_op(q, k_pages, v_pages, block_table, positions):
    """Paged decode attention. q: [B, nq, hd]; pages
    [n_pages, page_len, n_kv, hd]; ``block_table`` [B, nb]; ``positions``
    [B]. CPU: the blocked plain version; CUDA: the paged kernel. Returns
    the attention context [B, nq, hd] in ``q.dtype``."""
    return paged_attention(q, k_pages, v_pages, block_table, positions)


def rglru_scan_op(a, b, h0=None):
    """Linear recurrence h_t = a_t * h_{t-1} + b_t (mirrors
    ``repro.kernels.ops.rglru_scan_op``). a, b: [B, S, D] float32; ``h0``:
    optional [B, D] initial carry. CPU: the plain scan; CUDA: the kernel,
    which reads ``h0`` itself (the reference folds it into ``b[:, 0]``,
    the same f32 expression), any S >= 1 and any D."""
    return rglru_scan(a, b, h0)
