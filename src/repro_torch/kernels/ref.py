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


def paged_attention_ref(q, k_pages, v_pages, block_table, positions):
    """Blocked plain version of the paged decode-attention kernel: walks
    (sequence, page) like the kernel, with the same page-skip guard, f32
    online softmax and ``q.dtype`` rounding barriers at the score,
    probability, correction and accumulator hand-offs.

    q: [B, nq, hd]; ``k_pages``/``v_pages``: [n_pages, page_len, n_kv, hd];
    ``block_table``: [B, nb]; ``positions``: [B] (read on the host).
    Returns [B, nq, hd] in ``q.dtype``."""
    B, nq, hd = q.shape
    plen, n_kv = k_pages.shape[1], k_pages.shape[2]
    g = nq // n_kv
    nb = block_table.shape[1]
    scale = 1.0 / math.sqrt(hd)
    dt = q.dtype
    positions = [int(p) for p in positions.tolist()] \
        if torch.is_tensor(positions) else [int(p) for p in positions]
    table = block_table.tolist()
    f32 = torch.float32
    outs = []
    for b in range(B):
        pos_b = positions[b]
        m = torch.full((1, nq), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((1, nq), dtype=f32, device=q.device)
        acc = torch.zeros((nq, hd), dtype=f32, device=q.device)
        qf = q[b].float()
        for j in range(nb):
            if j * plen > pos_b:
                continue
            page = table[b][j]
            kf = k_pages[page].float().repeat_interleave(g, dim=1)
            vf = v_pages[page].float().repeat_interleave(g, dim=1)
            s = (torch.einsum("nh,tnh->nt", qf, kf) * scale).to(dt).float()
            t_abs = j * plen + torch.arange(plen, device=q.device)[None, :]
            s = torch.where(t_abs <= pos_b, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1)[None, :])
            p = torch.exp(s - m_new[0][:, None]).to(dt).float()
            corr = torch.exp(m - m_new).to(dt).float()
            m = m_new
            l = (l * corr).to(dt).float() + torch.sum(p, dim=-1)[None, :]
            acc = (acc * corr[0][:, None]).to(dt).float() \
                + torch.einsum("nt,tnh->nh", p, vf).to(dt).float()
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
