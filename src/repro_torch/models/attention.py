"""GQA attention for serving (mirrors the serving parts of
``repro.models.attention``): QKV projection with bias, plain-op causal and
sliding-window attention for prefill, full and blocked (no SDPA, so the
numerics stay the reference's), the paged arena's prefill scatter and
one-token decode through a block table, and the dense per-slot rolling
cache's prefill and decode (the window of local-attention archs).

Caches and arenas are updated in place (the reference returns new ones);
callers pass per-layer views of the pool's state.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30

# sequences at or above this length use the blocked online-softmax path
BLOCKED_ATTN_THRESHOLD = 2048
_BLOCK_Q = 512
_BLOCK_K = 512


def attn_init(gen, d: int, n_q: int, n_kv: int, hd: int, *,
              qkv_bias: bool = False, dtype=torch.bfloat16):
    return {
        "wq": dense_init(gen, d, n_q * hd, bias=qkv_bias, dtype=dtype),
        "wk": dense_init(gen, d, n_kv * hd, bias=qkv_bias, dtype=dtype),
        "wv": dense_init(gen, d, n_kv * hd, bias=qkv_bias, dtype=dtype),
        "wo": dense_init(gen, n_q * hd, d, dtype=dtype),
    }


def _project_qkv(p, x, n_q, n_kv, hd):
    B, S = x.shape[:2]
    q = (x @ p["wq"]["w"]).reshape(B, S, n_q, hd)
    k = (x @ p["wk"]["w"]).reshape(B, S, n_kv, hd)
    v = (x @ p["wv"]["w"]).reshape(B, S, n_kv, hd)
    if "b" in p["wq"]:
        q = q + p["wq"]["b"].reshape(n_q, hd)
        k = k + p["wk"]["b"].reshape(n_kv, hd)
        v = v + p["wv"]["b"].reshape(n_kv, hd)
    return q, k, v


def _gqa_scores(q, k):
    """q: [B,S,nq,hd], k: [B,T,nkv,hd] -> [B,nkv,G,S,T] in f32."""
    B, S, n_q, hd = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, S, n_kv, n_q // n_kv, hd)
    return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())


def _gqa_out(probs, v):
    """probs: [B,nkv,G,S,T], v: [B,T,nkv,hd] -> [B,S,nq*hd]."""
    B, n_kv, g, S, T = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, n_kv * g * v.shape[-1])


def _mask(i, j, window: int):
    """Causal, and within ``window`` positions when one is set."""
    m = j <= i
    if window:
        m = m & (j > i - window)
    return m


def _dense_attention(q, k, v, positions, hd, window: int = 0):
    scores = _gqa_scores(q, k) / math.sqrt(hd)   # [B,kv,G,S,T] f32
    i = positions[:, None, None, :, None]        # query pos
    j = positions[:, None, None, None, :]        # key pos
    scores = torch.where(_mask(i, j, window), scores, NEG_INF)
    return _gqa_out(torch.softmax(scores, dim=-1), v)


def _blocked_attention(q, k, v, positions, hd, window: int = 0,
                       block_q: int = _BLOCK_Q, block_k: int = _BLOCK_K):
    """Online-softmax causal (optionally sliding-window) attention over
    [block_q x block_k] tiles; peak memory O(S * block_k) instead of
    O(S^2)."""
    B, S, n_q_heads, _ = q.shape
    n_kv = k.shape[2]
    g = n_q_heads // n_kv
    nq, nk = S // block_q, S // block_k
    qb = q.reshape(B, nq, block_q, n_kv, g, hd)
    kb = k.reshape(B, nk, block_k, n_kv, hd)
    vb = v.reshape(B, nk, block_k, n_kv, hd)
    pos_q = positions.reshape(B, nq, block_q)
    pos_k = positions.reshape(B, nk, block_k)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        qf = qb[:, qi].float()
        m = torch.full((B, n_kv, g, block_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, n_kv, g, block_q, hd), dtype=torch.float32,
                          device=q.device)
        for kj in range(nk):
            s = torch.einsum("bqkgh,btkh->bkgqt", qf,
                             kb[:, kj].float()) * scale
            i_ = pos_q[:, qi][:, None, None, :, None]
            j_ = pos_k[:, kj][:, None, None, None, :]
            s = torch.where(_mask(i_, j_, window), s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p, vb[:, kj].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, block_q,
                                                       n_kv * g * hd))
    return torch.cat(outs, dim=1)


def paged_prefill_attention(p, x, positions, arena, block_table, *,
                            n_q: int, n_kv: int, hd: int, rope_theta: float,
                            lengths=None):
    """Full-sequence causal prefill that scatters K/V rows through a block
    table into a paged arena (in place). ``arena``: one layer's
    ``{"k","v"}`` of shape [n_pages, page_len, n_kv, hd]; ``block_table``:
    [B, nb]. Pad rows (``s >= lengths[b]``) are not written. Returns
    out [B, S, d]."""
    B, S = x.shape[:2]
    plen = arena["k"].shape[1]
    nb = block_table.shape[1]
    q, k, v = _project_qkv(p, x, n_q, n_kv, hd)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)

    if S >= BLOCKED_ATTN_THRESHOLD and S % _BLOCK_Q == 0 \
            and S % _BLOCK_K == 0:
        out = _blocked_attention(q, k, v, positions, hd)
    else:
        out = _dense_attention(q, k, v, positions, hd)

    valid = torch.arange(S, device=x.device)[None, :] < lengths[:, None]
    pg_ix = torch.clamp(positions // plen, 0, nb - 1).long()
    pg = block_table.long().gather(1, pg_ix)                   # [B, S]
    row = torch.remainder(positions, plen).long()
    arena["k"][pg[valid], row[valid]] = k[valid]
    arena["v"][pg[valid], row[valid]] = v[valid]
    return out.to(x.dtype) @ p["wo"]["w"]


def paged_decode_attention(p, x, arena, block_table, cur_pos, *, n_q: int,
                           n_kv: int, hd: int, rope_theta: float):
    """One-token decode against a paged arena through a block table.

    x: [B, 1, d]; cur_pos: [B] absolute positions; ``arena``: one layer's
    ``{"k","v"}`` [n_pages, page_len, n_kv, hd], updated in place with the
    new rows; ``block_table``: [B, nb] (idle slots carry zero rows, so
    their writes land in scratch page 0, never read unmasked). On CUDA the
    attention runs the paged kernel; on the CPU it gathers the table's
    pages into logical row order and applies the dense score / mask /
    softmax ops (the reference's CPU path). Returns out [B, 1, d]."""
    B = x.shape[0]
    plen = arena["k"].shape[1]
    nb = block_table.shape[1]
    q, k, v = _project_qkv(p, x, n_q, n_kv, hd)
    pos = cur_pos.to(torch.int32).reshape(B, 1)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)

    bt = block_table.long()
    pg = bt.gather(1, torch.clamp(pos.long() // plen, 0, nb - 1))[:, 0]
    row = torch.remainder(pos[:, 0], plen).long()
    arena["k"][pg, row] = k[:, 0]
    arena["v"][pg, row] = v[:, 0]

    if x.device.type != "cpu":
        from repro_torch.kernels import ops
        ctx = ops.paged_attention_op(q[:, 0].contiguous(), arena["k"],
                                     arena["v"], block_table, pos[:, 0])
        out = ctx.reshape(B, 1, n_q * hd).to(x.dtype)
    else:
        ck = arena["k"][bt].reshape(B, nb * plen, n_kv, hd)
        cv = arena["v"][bt].reshape(B, nb * plen, n_kv, hd)
        scores = _gqa_scores(q, ck) / math.sqrt(hd)     # [B,kv,G,1,T]
        t = torch.arange(nb * plen, device=x.device)
        n_fill = torch.clamp(pos[:, 0] + 1, max=nb * plen)
        written = t[None, :] < n_fill[:, None]          # [B, T]
        scores = torch.where(written[:, None, None, None, :], scores,
                             NEG_INF)
        out = _gqa_out(torch.softmax(scores, dim=-1), cv).to(x.dtype)
    return out @ p["wo"]["w"]


def init_cache(batch: int, n_kv: int, hd: int, cache_len: int,
               dtype=torch.bfloat16, kv_bits: int = 0, device=None):
    """Per-layer rolling KV cache ``{"k","v"}: [batch, cache_len, n_kv,
    hd]``; ``cache_len`` is the window for windowed archs, the full
    context otherwise. The int8 cache (``kv_bits=8``) is not ported."""
    if kv_bits:
        raise NotImplementedError("repro_torch has no int8 KV cache yet")
    shape = (batch, cache_len, n_kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_attention(p, x, positions, cache, *, n_q: int, n_kv: int,
                      hd: int, rope_theta: float, window: int = 0,
                      lengths=None):
    """Full-sequence prefill that also fills the rolling cache (in place).

    Causal (optionally sliding-window) attention over the whole prompt in
    one pass; each row's last ``min(len, cache_len)`` real positions land
    in their rolling slots ``pos % cache_len``. Pad rows (``s >=
    lengths[b]``) are not written (the reference drops them with an
    out-of-bounds index; here they are masked out). x: [B, S, d];
    positions: [B, S]; ``cache``: one layer's ``{"k","v"}`` [B, cache_len,
    n_kv, hd]. Returns out [B, S, d]."""
    B, S = x.shape[:2]
    clen = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, n_q, n_kv, hd)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    lengths = lengths.to(device=x.device, dtype=torch.long)

    # decode only ever sees the last ``clen`` positions, so the prefill
    # window is capped at the cache
    w_eff = min(window, clen) if window else window
    if S >= BLOCKED_ATTN_THRESHOLD and S % _BLOCK_Q == 0 \
            and S % _BLOCK_K == 0:
        out = _blocked_attention(q, k, v, positions, hd, w_eff)
    else:
        out = _dense_attention(q, k, v, positions, hd, w_eff)

    keep = min(S, clen)
    idx = lengths[:, None] - keep + torch.arange(keep, device=x.device)
    valid = idx >= 0                                            # [B, keep]
    idx_c = torch.clamp(idx, 0, S - 1)
    pos_g = torch.gather(positions.long(), 1, idx_c)
    slot = torch.remainder(pos_g, clen)
    b_ix = torch.arange(B, device=x.device)[:, None].expand(B, keep)
    rows = b_ix[valid], slot[valid]
    src = b_ix[valid], idx_c[valid]
    cache["k"][rows] = k[src]
    cache["v"][rows] = v[src]
    return out.to(x.dtype) @ p["wo"]["w"]


def decode_attention(p, x, cache, cur_pos, *, n_q: int, n_kv: int, hd: int,
                     rope_theta: float, window: int = 0):
    """One-token decode against the rolling cache, each sequence at its own
    depth. x: [B, 1, d]; cur_pos: [B] absolute positions; ``cache``: one
    layer's ``{"k","v"}`` [B, cache_len, n_kv, hd], whose row ``pos %
    cache_len`` takes the new token (in place). With the cache as long as
    the window every written slot is inside it, so the mask reduces to
    "has been written". Returns out [B, 1, d]."""
    B = x.shape[0]
    clen = cache["k"].shape[1]
    q, k, v = _project_qkv(p, x, n_q, n_kv, hd)
    pos = cur_pos.to(torch.int32).reshape(B, 1)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    b_ix = torch.arange(B, device=x.device)
    slot = torch.remainder(pos[:, 0], clen).long()
    cache["k"][b_ix, slot] = k[:, 0]
    cache["v"][b_ix, slot] = v[:, 0]
    scores = _gqa_scores(q, cache["k"]) / math.sqrt(hd)        # [B,kv,G,1,T]
    t = torch.arange(clen, device=x.device)
    n_fill = torch.clamp(pos[:, 0] + 1, max=clen)
    written = t[None, :] < n_fill[:, None]                     # [B, T]
    scores = torch.where(written[:, None, None, None, :], scores, NEG_INF)
    out = _gqa_out(torch.softmax(scores, dim=-1), cache["v"]).to(x.dtype)
    return out @ p["wo"]["w"]
