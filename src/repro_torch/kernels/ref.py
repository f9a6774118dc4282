"""Plain PyTorch versions of the hand-written kernels (mirrors
``repro.kernels.ref`` op for op, ``.to(dtype).float()`` rounding barriers
included). The CPU path runs them; on the card they are the oracles the
kernels are held against."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _rms(xf, eps: float = 1e-6):
    return xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)


def _final_norm(xf, norm_scale, norm_bias, norm_kind: str):
    if norm_kind == "rmsnorm":
        y = _rms(xf)
    else:                                # layernorm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * norm_scale.float()
    if norm_bias is not None:
        y = y + norm_bias.float()
    return y


def bottleneck_quant_ref(x, w, bits: int = 8):
    """Fused down-projection + row-wise symmetric quantization (mirrors
    ``repro.kernels.ref.bottleneck_quant_ref``). x: [M, K] bf16/f32, w:
    [K, N] -> (codes int8 [M, N], scales f32 [M, 1]); ``bits=1`` is the
    ternary code (qmax floored at 1). The divisor of the scale is a tensor:
    on CUDA, PyTorch divides by a Python scalar as a multiply by its
    reciprocal, which is not the reference's f32 division."""
    z = x.float() @ w.float()
    qm = max((1 << (bits - 1)) - 1, 1)
    absmax = torch.amax(torch.abs(z), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, qm)
    codes = torch.clamp(torch.round(z / scale), -qm, qm).to(torch.int8)
    return codes, scale


def dequant_matmul_ref(codes, scales, w, out_dtype=torch.bfloat16):
    """Fused dequantize + up-projection (mirrors
    ``repro.kernels.ref.dequant_matmul_ref``). codes: int8 [M, N], scales:
    f32 [M, 1], w: [N, D] -> ``((f32(codes) * scales) @ f32(w))`` as
    ``out_dtype``, [M, D]."""
    z = codes.float() * scales
    return (z @ w.float()).to(out_dtype)


def boundary_mixed_ref(stacked, x, mode_idx, *, dtype=torch.bfloat16):
    """Per-row mixed-mode bottleneck boundary (the serving reference).

    x: [B, S, d]; mode_idx: [B] int32 in [0, M]: 0 transmits the raw code z,
    m >= 1 routes row b through head m-1 of ``stacked``: rmsnorm +
    down-projection, the quantize -> dequantize wire round-trip at that
    row's bit width, and the up-projection. Returns [B, S, d] in x.dtype.
    """
    M = stacked["width"].shape[0]
    hid = torch.clamp(mode_idx.long() - 1, 0, M - 1)
    h = _rms(x.float()) * stacked["norm_scale"][hid][:, None, :].float()
    z = torch.einsum("bsd,bdw->bsw", h.to(x.dtype),
                     stacked["down_w"][hid]).float()
    lane = torch.arange(z.shape[-1], device=x.device)
    z = torch.where(lane[None, None, :] < stacked["width"][hid][:, None, None],
                    z, 0.0)
    bits_h = stacked["bits"][hid][:, None, None]
    qm = torch.clamp(torch.bitwise_left_shift(
        torch.ones_like(bits_h), torch.clamp(bits_h, min=1) - 1) - 1,
        min=1).float()
    absmax = torch.amax(torch.abs(z), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / qm
    codes = torch.maximum(torch.minimum(torch.round(z / scale), qm), -qm)
    wired = torch.where(bits_h == 0, z, codes * scale)
    y = torch.einsum("bsw,bwd->bsd", wired.to(dtype), stacked["up_w"][hid])
    return torch.where(mode_idx[:, None, None] == 0, x, y.to(x.dtype))


def boundary_mixed_grouped_ref(xp, down_w, up_w, norm_scale, hid_g, nchunk_g,
                               width_g, bits_g, *, block_r: int,
                               block_w: int = 128, dtype=torch.bfloat16):
    """Blocked plain version of the grouped boundary kernel: per
    ``block_r``-row mode-uniform block, rmsnorm -> down-projection chunk by
    chunk (each chunk's f32 sum rounded to the model dtype, lanes >= width
    zeroed) -> row-wise quant/dequant -> up-projection with f32
    accumulation. Blocks with zero chunks pass through. Loops over row
    blocks in Python (tables are read on the host)."""
    P, d = xp.shape
    wmax = down_w.shape[2]
    hid_g, nchunk_g = hid_g.tolist(), nchunk_g.tolist()
    width_g, bits_g = width_g.tolist(), bits_g.tolist()
    outs = []
    for g in range(P // block_r):
        rows = xp[g * block_r:(g + 1) * block_r]
        hid, nch, width, bits = hid_g[g], nchunk_g[g], width_g[g], bits_g[g]
        if nch == 0:                           # raw passthrough (mode 0)
            outs.append(rows)
            continue
        h = (_rms(rows.float()) * norm_scale[hid].float()).to(xp.dtype)
        z = torch.zeros((block_r, wmax), dtype=torch.float32,
                        device=xp.device)
        for w in range(nch):
            cols = slice(w * block_w, (w + 1) * block_w)
            zc = (h.float() @ down_w[hid, :, cols].float()
                  ).to(xp.dtype).float()
            # the last chunk of a bank narrower than block_w is short
            lane = w * block_w + torch.arange(zc.shape[1], device=xp.device)
            z[:, cols] = torch.where(lane[None, :] < width, zc, 0.0)
        qm = float(max((1 << (max(bits, 1) - 1)) - 1, 1))
        absmax = torch.amax(torch.abs(z), dim=-1, keepdim=True)
        scale = torch.clamp(absmax, min=1e-8) / qm
        codes = torch.clamp(torch.round(z / scale), -qm, qm)
        wired = z if bits == 0 else codes * scale
        y = wired.to(dtype).float() @ up_w[hid].float()
        outs.append(y.to(xp.dtype))
    return torch.cat(outs, dim=0)


def boundary_mixed_rows_ref(x2, row_mode, bank, dtype=torch.bfloat16):
    """Plain version of the boundary kernel on the rows in place. x2: [N,
    d]; ``row_mode``: [N] mode of each row (0 = raw, as the reference reads
    it: anything else is head clamp(m - 1, 0, M - 1)); ``bank``: the
    stacked bank. Per row, in the kernel's order: rmsnorm x head scale ->
    model dtype; down-projection with f32 sums, each lane rounded to the
    model dtype (the per-chunk barrier), lanes >= width zeroed; row-wise
    absmax quant -> dequant at the head's bits (none at 0) -> ``dtype``;
    up-projection -> model dtype. Mode-0 rows are copied. The projections
    sum in float64 and round once: the value every f32 summation order
    (the kernel's, the references') approximates, so each of them sits
    within its own rounding envelope of it. Each row is computed on its own
    (one GEMV a projection), so a row's output does not depend on the rows
    beside it. Returns [N, d]."""
    M = bank["width"].shape[0]
    mode = row_mode.long()
    hid_r = torch.clamp(mode - 1, 0, M - 1).tolist()
    out = x2.clone()
    for r in torch.nonzero(mode != 0).reshape(-1).tolist():
        hid = hid_r[r]
        width, bits = int(bank["width"][hid]), int(bank["bits"][hid])
        h = (_rms(x2[r:r + 1].float())
             * bank["norm_scale"][hid].float()).to(x2.dtype)
        z = (h.double() @ bank["down_w"][hid].double()).to(x2.dtype).float()
        z[:, width:] = 0.0
        if bits != 0:
            absmax = torch.amax(torch.abs(z), dim=-1, keepdim=True)
            # a tensor divisor: CUDA divides by a Python scalar as a multiply
            qm = torch.full_like(absmax, max((1 << (bits - 1)) - 1, 1))
            scale = torch.clamp(absmax, min=1e-8) / qm
            z = torch.clamp(torch.round(z / scale), -qm, qm) * scale
        y = z.to(dtype).double() @ bank["up_w"][hid].double()
        out[r] = y[0].to(x2.dtype)
    return out


def _sum_seq(x):
    """f32 sum over the last axis in index order: x[..., 0] + x[..., 1] +
    ... (the paged kernels' order)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _dot_seq(a, b):
    """f32 dot product over the last axis, accumulated in index order (the
    paged kernels' order; their FMAs give the same bits wherever the
    products are exact in f32, as products of bf16 values are)."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def _paged_scores(qf, k_pages, pages, g, scale, dt):
    """Rounded scores [n, nq, plen] of a sequence's pages ``pages`` (page
    ids, in order) for its f32 query rows qf [nq, hd]."""
    kf = k_pages[pages].float().repeat_interleave(g, dim=2)  # [n,plen,nq,hd]
    return (_dot_seq(qf, kf) * scale).to(dt).float().transpose(1, 2)


def _page_pv(p, vf):
    """f32 p . v of one page (the caller rounds it): p [nq, plen], vf
    [plen, nq, hd] -> [nq, hd], the rows summed in order."""
    acc = p[:, 0, None] * vf[0]
    for t in range(1, p.shape[1]):
        acc = acc + p[:, t, None] * vf[t]
    return acc


def _paged_args(q, k_pages, block_table, positions):
    B, nq, hd = q.shape
    plen, n_kv = k_pages.shape[1], k_pages.shape[2]
    pos = [int(p) for p in positions.tolist()] \
        if torch.is_tensor(positions) else [int(p) for p in positions]
    nb = block_table.shape[1]
    live = [0 if p < 0 else min(nb, p // plen + 1) for p in pos]
    return (B, nq, hd, plen, nq // n_kv, 1.0 / math.sqrt(hd), pos, live,
            block_table.tolist())


def paged_attention_ref(q, k_pages, v_pages, block_table, positions):
    """Blocked plain version of the paged decode-attention kernels: walks
    (sequence, page) like the reference, with the same page-skip guard,
    f32 online softmax and ``q.dtype`` rounding barriers at the score,
    probability, correction and accumulator hand-offs. The reference
    leaves the order of its sums (q . k over the head dim, p over a page's
    rows, p . v over them) to XLA; here each runs in index order, the
    kernels' order, so that in bf16 the two agree bit for bit.

    q: [B, nq, hd]; ``k_pages``/``v_pages``: [n_pages, page_len, n_kv, hd];
    ``block_table``: [B, nb]; ``positions``: [B] (read on the host).
    Returns [B, nq, hd] in ``q.dtype``."""
    B, nq, hd, plen, g, scale, pos, live, table = _paged_args(
        q, k_pages, block_table, positions)
    dt = q.dtype
    f32 = torch.float32
    outs = []
    for b in range(B):
        m = torch.full((1, nq), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((1, nq), dtype=f32, device=q.device)
        acc = torch.zeros((nq, hd), dtype=f32, device=q.device)
        pages = table[b][:live[b]]
        s_all = _paged_scores(q[b].float(), k_pages, pages, g, scale, dt)
        for j, page in enumerate(pages):
            t_abs = j * plen + torch.arange(plen, device=q.device)[None, :]
            s = torch.where(t_abs <= pos[b], s_all[j], NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1)[None, :])
            p = torch.exp(s - m_new[0][:, None]).to(dt).float()
            corr = torch.exp(m - m_new).to(dt).float()
            m = m_new
            l = (l * corr).to(dt).float() + _sum_seq(p)[None, :]
            vf = v_pages[page].float().repeat_interleave(g, dim=1)
            acc = (acc * corr[0][:, None]).to(dt).float() \
                + _page_pv(p, vf).to(dt).float()
        outs.append((acc / l[0][:, None]).to(dt))
    return torch.stack(outs)


def paged_attention_split_ref(q, k_pages, v_pages, block_table, positions,
                              pages_per_split: int):
    """Blocked plain mirror of the paged kernels' split order: a sequence's
    live pages are cut into ranges of ``pages_per_split``; per range (A) the
    rounded, masked scores and each page's maximum, then (B) the running
    max entering the range (the earlier pages' maxima), each page's m_j, p,
    corr, psum and rounded pv; last (C) the serial l / acc combine over all
    pages and the division. Every value is the one
    ``paged_attention_ref``'s sequential walk gives, op for op, so the two
    agree bit for bit at every ``pages_per_split``. Shapes as
    ``paged_attention_ref``."""
    B, nq, hd, plen, g, scale, pos, live, table = _paged_args(
        q, k_pages, block_table, positions)
    dt = q.dtype
    f32 = torch.float32
    outs = []
    for b in range(B):
        n_live, pages = live[b], table[b][:live[b]]
        ranges = [range(r, min(r + pages_per_split, n_live))
                  for r in range(0, n_live, pages_per_split)]
        s_pg, pmax, stats = {}, {}, {}
        for rng in ranges:                     # A: scores, page maxima
            s_r = _paged_scores(q[b].float(), k_pages,
                                [pages[j] for j in rng], g, scale, dt)
            for i, j in enumerate(rng):
                t_abs = j * plen + torch.arange(plen, device=q.device)[None, :]
                s_pg[j] = torch.where(t_abs <= pos[b], s_r[i], NEG_INF)
                pmax[j] = torch.amax(s_pg[j], dim=-1)[None, :]
        for rng in ranges:                     # B: p, corr, psum, pv
            m = torch.full((1, nq), NEG_INF, dtype=f32, device=q.device)
            for j in range(rng.start):         # the earlier pages' maxima
                m = torch.maximum(m, pmax[j])
            for j in rng:
                m_new = torch.maximum(m, pmax[j])
                p = torch.exp(s_pg[j] - m_new[0][:, None]).to(dt).float()
                corr = torch.exp(m - m_new).to(dt).float()
                vf = v_pages[pages[j]].float().repeat_interleave(g, dim=1)
                stats[j] = (corr, _sum_seq(p)[None, :],
                            _page_pv(p, vf).to(dt).float())
                m = m_new
        l = torch.zeros((1, nq), dtype=f32, device=q.device)
        acc = torch.zeros((nq, hd), dtype=f32, device=q.device)
        for j in range(n_live):                # C: the serial combine
            corr, psum, pv = stats[j]
            l = (l * corr).to(dt).float() + psum
            acc = (acc * corr[0][:, None]).to(dt).float() + pv
        outs.append((acc / l[0][:, None]).to(dt))
    return torch.stack(outs)


def decode_tail_ref(x, norm_scale, norm_bias, heads, head_idx=None, *,
                    norm_kind: str = "rmsnorm", tied: bool = False):
    """Serving reference for the fused decode tail (final norm -> LM head
    -> argmax), expression-identical to the ``norm_apply -> lm_logits ->
    argmax`` chain. x: [B, S, d]; ``heads``: [H, d, V] stacked LM heads, or
    the [1, V, d] embedding table when ``tied``; ``head_idx``: [B] per-row
    head (None = head 0). Returns int32 tokens [B, S]."""
    xn = _final_norm(x.float(), norm_scale, norm_bias, norm_kind
                     ).to(x.dtype).float()
    if tied:
        logits = torch.einsum("bsd,vd->bsv", xn, heads[0].float())
    elif heads.shape[0] == 1:
        logits = xn @ heads[0].float()
    else:
        hid = torch.zeros(x.shape[0], dtype=torch.long, device=x.device) \
            if head_idx is None else head_idx.long()
        logits = torch.einsum("bsd,bdv->bsv", xn, heads[hid].float())
    return torch.argmax(logits, dim=-1).to(torch.int32)


def decode_tail_grouped_ref(xp, heads, norm_scale, norm_bias, hid_g, *,
                            block_r: int, block_v: int = 512,
                            norm_kind: str = "rmsnorm"):
    """Blocked plain version of the fused decode-tail kernel: per
    head-uniform row block, the final norm rounded through the model dtype,
    vocab-chunked f32 logits, a strict-``>`` running lane max and a final
    lowest-index reduce (``jnp.argmax``'s tie-break). Returns [P, 128]
    int32 (the token broadcast across lanes)."""
    P, d = xp.shape
    n_v = heads.shape[-1] // block_v
    hid_g = hid_g.tolist()
    outs = []
    for g in range(P // block_r):
        rows = xp[g * block_r:(g + 1) * block_r]
        hid = hid_g[g]
        h = _final_norm(rows.float(), norm_scale, norm_bias, norm_kind
                        ).to(xp.dtype).float()
        best = torch.full((block_r, block_v), -math.inf, dtype=torch.float32,
                          device=xp.device)
        bidx = torch.zeros((block_r, block_v), dtype=torch.int32,
                           device=xp.device)
        for v in range(n_v):
            logits = h @ heads[hid, :, v * block_v:(v + 1) * block_v].float()
            lane = v * block_v + torch.arange(block_v, dtype=torch.int32,
                                              device=xp.device)[None, :]
            better = logits > best
            best = torch.where(better, logits, best)
            bidx = torch.where(better, lane, bidx)
        m = torch.amax(best, dim=-1, keepdim=True)
        tok = torch.amin(torch.where(best == m, bidx, 2 ** 31 - 1), dim=-1,
                         keepdim=True)
        outs.append(tok.expand(block_r, 128).to(torch.int32))
    return torch.cat(outs, dim=0)


def rglru_scan_ref(a, b, h0=None):
    """Gated linear recurrence h_t = a_t * h_{t-1} + b_t, one step at a
    time (mirrors ``repro.kernels.ref.rglru_scan_ref``): each step is a
    multiply and an add, rounded separately in float32.

    a, b: [B, S, D] float32; ``h0``: optional [B, D] initial carry (zeros
    when omitted). Returns h: [B, S, D] float32."""
    B, S, D = a.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty((B, S, D), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
