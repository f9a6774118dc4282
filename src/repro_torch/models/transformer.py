"""Decoder-only transformer for the ported families (mirrors the serving
parts of ``repro.models.transformer``): homogeneous attention stacks
(dense GQA) and heterogeneous block patterns (RecurrentGemma's RG-LRU and
local-attention blocks).

Homogeneous archs keep stacked ``[L, ...]`` layer leaves, and the layer
runners loop over per-layer slices (views, no copies) where the reference
scans; heterogeneous archs keep a tuple of per-layer trees, as the
reference does. Decode state is updated in place: the paged arena
``{"k", "v"}`` of ``[L, n_pages, page_len, n_kv, hd]`` leaves, stacked
dense rolling caches ``[L, B, cache_len, n_kv, hd]``, or a tuple of
per-layer states (rolling caches and RG-LRU carries).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attn_init, decode_attention,
                                          init_cache, paged_decode_attention,
                                          paged_prefill_attention,
                                          prefill_attention)
from repro_torch.models.layers import (embed_apply, embed_init, dense_init,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init)
from repro_torch.models.rglru import (rglru_init, rglru_prefill,
                                      rglru_state_init, rglru_step)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_KINDS = ("attn", "rglru")


def model_dtype(cfg: ModelConfig):
    return _DTYPES[cfg.dtype]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """The tensor leaves of a nested dict / list / tuple, in order."""
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in tree_leaves(v)]
    return [tree]


def layer_slice(layers, i: int):
    """Layer ``i`` of stacked ``[L, ...]`` leaves (views)."""
    return tree_map(lambda a: a[i], layers)


def _kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    return tuple(cfg.block_kind(i) for i in range(cfg.n_layers))


def _check_supported(cfg: ModelConfig):
    if cfg.is_moe or cfg.frontend != "none" \
            or not set(_kinds(cfg)) <= set(_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs dense attention and RG-LRU "
            f"blocks only (xLSTM, MoE and multimodal archs are later "
            f"slices)")


def _attn_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window or cfg.local_window


def full_attention_arch(cfg: ModelConfig) -> bool:
    """True if any layer attends the full context (no window): the KV cache
    is addressed by absolute position, so serving must keep
    ``prompt_len + max_new_tokens <= cache_len``."""
    return (not _attn_window(cfg)) and any(
        cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ModelConfig, kind: str = "attn"):
    dt = model_dtype(cfg)
    p: Dict[str, Any] = {
        "norm1": norm_init(cfg.d_model, cfg.norm, dtype=dt, device=gen.device)}
    if kind == "attn":
        p["mix"] = attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim, qkv_bias=cfg.qkv_bias, dtype=dt)
    elif kind == "rglru":
        p["mix"] = rglru_init(gen, cfg.d_model, cfg.d_rnn or cfg.d_model,
                              dtype=dt)
    else:
        raise ValueError(kind)
    if cfg.d_ff:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dtype=dt,
                               device=gen.device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dt)
    return p


def _mlp_residual(p, x, cfg: ModelConfig):
    if "mlp" in p:
        x = x + mlp_apply(p["mlp"], norm_apply(p["norm2"], x, cfg.norm),
                          cfg.act)
    return x


def _attn_dims(cfg: ModelConfig):
    return dict(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.head_dim,
                rope_theta=cfg.rope_theta)


def block_apply_decode(p, x, state, cur_pos, cfg: ModelConfig,
                       kind: str = "attn", block_table=None):
    """One-token decode through one block; ``state`` (its paged arena,
    rolling cache or RG-LRU carry) updates in place. Returns x."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    if kind == "attn" and block_table is not None:
        mix = paged_decode_attention(p["mix"], h, state, block_table,
                                     cur_pos, **_attn_dims(cfg))
    elif kind == "attn":
        mix = decode_attention(p["mix"], h, state, cur_pos,
                               window=_attn_window(cfg), **_attn_dims(cfg))
    elif kind == "rglru":
        mix = rglru_step(p["mix"], h, state)
    else:
        raise ValueError(kind)
    return _mlp_residual(p, x + mix, cfg)


def block_apply_prefill(p, x, positions, state, cfg: ModelConfig,
                        kind: str = "attn", lengths=None, block_table=None):
    """Full-sequence block that also fills its decode state (in place):
    K/V rows into the arena through ``block_table`` or into the rolling
    cache, or the RG-LRU carry. Returns x."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    if kind == "attn" and block_table is not None:
        mix = paged_prefill_attention(p["mix"], h, positions, state,
                                      block_table, lengths=lengths,
                                      **_attn_dims(cfg))
    elif kind == "attn":
        mix = prefill_attention(p["mix"], h, positions, state,
                                window=_attn_window(cfg), lengths=lengths,
                                **_attn_dims(cfg))
    elif kind == "rglru":
        mix = rglru_prefill(p["mix"], h, state, lengths=lengths)
    else:
        raise ValueError(kind)
    return _mlp_residual(p, x + mix, cfg)


def block_state_init(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device=None):
    dt = model_dtype(cfg)
    if kind == "attn":
        w = _attn_window(cfg)
        clen = min(cache_len, w) if w else cache_len
        return init_cache(batch, cfg.n_kv_heads, cfg.head_dim, clen,
                          dtype=dt, device=device)
    if kind == "rglru":
        return rglru_state_init(batch, cfg.d_rnn or cfg.d_model, dtype=dt,
                                device=device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random parameters on ``gen.device`` with the reference's shapes,
    scales and tree (layers stacked ``[L, ...]`` when homogeneous, a tuple
    of per-layer trees otherwise)."""
    _check_supported(cfg)
    dt = model_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt)}
    blocks = [block_init(gen, cfg, cfg.block_kind(i))
              for i in range(cfg.n_layers)]
    params["layers"] = _stack(blocks) if cfg.homogeneous else tuple(blocks)
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dtype=dt,
                                     device=gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype=dt)
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device=None):
    """Per-layer decode state: stacked ``{"k","v"}: [L, batch, clen, n_kv,
    hd]`` for homogeneous archs (a paged pool passes (arena pages,
    page_len)), a tuple of per-layer states otherwise."""
    if cfg.homogeneous:
        one = block_state_init(cfg, "attn", batch, cache_len, "meta")
        return tree_map(lambda a: torch.zeros((cfg.n_layers,) + a.shape,
                                              dtype=a.dtype, device=device),
                        one)
    return tuple(block_state_init(cfg, kind, batch, cache_len, device)
                 for kind in _kinds(cfg))


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):
    """tokens: [B, S] int -> [B, S, d]."""
    x = embed_apply(params["embed"], tokens.long())
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def norm_apply_final(params, x, cfg: ModelConfig):
    return norm_apply(params["final_norm"], x, cfg.norm)


def lm_logits(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x.float(),
                            params["embed"]["table"].float())
    return x.float() @ params["lm_head"]["w"].float()


def decode_tail_tokens(params, x, cfg: ModelConfig):
    """Fused decode tail: final norm -> LM head -> argmax in one kernel on
    CUDA (``ops.decode_tail_op``); on the CPU its serving reference, which
    is expression-identical to the norm / lm_logits / argmax chain.
    x: [B, S, d] decoder output (pre final norm). Returns int32 [B, S]."""
    from repro_torch.kernels import ops
    fn = params["final_norm"]
    if cfg.tie_embeddings:
        heads, tied = params["embed"]["table"][None], True
    else:
        heads, tied = params["lm_head"]["w"][None], False
    return ops.decode_tail_op(x, fn["scale"], fn.get("bias"), heads,
                              norm_kind=cfg.norm, tied=tied)


# ---------------------------------------------------------------------------
# layer runners (shared by the split encoder and decoder)
# ---------------------------------------------------------------------------

def _per_layer(layers, states, cfg: ModelConfig,
               kinds: Optional[Tuple[str, ...]]):
    """(params, state, kind) of each layer of a group: slices of stacked
    leaves for homogeneous archs, the tuples' entries otherwise."""
    if cfg.homogeneous:
        n = next(iter(states.values())).shape[0]
        for i in range(n):
            yield (layer_slice(layers, i), layer_slice(states, i), "attn")
    else:
        kinds = kinds or _kinds(cfg)[:len(layers)]
        yield from zip(layers, states, kinds)


def run_layers_decode(layers, x, states, cur_pos, cfg: ModelConfig,
                      kinds: Optional[Tuple[str, ...]] = None,
                      block_table=None):
    """One-token decode through a group of layers; ``states`` (the same
    layers' decode state) update in place. ``block_table`` (paged pool) is
    shared by every attention layer. Returns x."""
    for lp, st, kind in _per_layer(layers, states, cfg, kinds):
        x = block_apply_decode(lp, x, st, cur_pos, cfg, kind, block_table)
    return x


def run_layers_prefill(layers, x, positions, states, cfg: ModelConfig,
                       kinds: Optional[Tuple[str, ...]] = None, lengths=None,
                       block_table=None):
    """Full-sequence pass through a group of layers that fills every
    layer's decode state (in place). Returns x."""
    for lp, st, kind in _per_layer(layers, states, cfg, kinds):
        x = block_apply_prefill(lp, x, positions, st, cfg, kind, lengths,
                                block_table)
    return x
