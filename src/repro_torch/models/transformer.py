"""Decoder-only transformer for homogeneous full-attention archs (mirrors
the attention-family parts of ``repro.models.transformer``).

Parameters keep the reference's tree: ``params["layers"]`` holds stacked
``[L, ...]`` leaves, and the layer runners loop over per-layer slices
(views, no copies) where the reference scans. Decode state is the paged
arena ``{"k", "v"}`` of ``[L, n_pages, page_len, n_kv, hd]`` leaves,
updated in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attn_init, paged_decode_attention,
                                          paged_prefill_attention)
from repro_torch.models.layers import (embed_apply, embed_init, dense_init,
                                       mlp_apply, mlp_init, norm_apply,
                                       norm_init)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_dtype(cfg: ModelConfig):
    return _DTYPES[cfg.dtype]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def layer_slice(layers, i: int):
    """Layer ``i`` of stacked ``[L, ...]`` leaves (views)."""
    return tree_map(lambda a: a[i], layers)


def _check_supported(cfg: ModelConfig):
    if not cfg.homogeneous or cfg.is_moe or cfg.frontend != "none" \
            or cfg.sliding_window or cfg.local_window:
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs homogeneous full-attention dense "
            f"archs only (recurrent, MoE, windowed and multimodal archs are "
            f"later slices)")


def full_attention_arch(cfg: ModelConfig) -> bool:
    """True if any layer attends the full context (no window)."""
    return not (cfg.sliding_window or cfg.local_window) and any(
        cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ModelConfig):
    dt = model_dtype(cfg)
    p: Dict[str, Any] = {
        "norm1": norm_init(cfg.d_model, cfg.norm, dtype=dt, device=gen.device),
        "mix": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, qkv_bias=cfg.qkv_bias, dtype=dt)}
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


def block_apply_decode(p, x, arena, cur_pos, cfg: ModelConfig, block_table):
    """One-token decode through one block against its paged arena."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    x = x + paged_decode_attention(
        p["mix"], h, arena, block_table, cur_pos, n_q=cfg.n_heads,
        n_kv=cfg.n_kv_heads, hd=cfg.head_dim, rope_theta=cfg.rope_theta)
    return _mlp_residual(p, x, cfg)


def block_apply_prefill(p, x, positions, arena, cfg: ModelConfig,
                        lengths=None, block_table=None):
    """Full-sequence block that scatters its K/V rows into the arena."""
    h = norm_apply(p["norm1"], x, cfg.norm)
    x = x + paged_prefill_attention(
        p["mix"], h, positions, arena, block_table, n_q=cfg.n_heads,
        n_kv=cfg.n_kv_heads, hd=cfg.head_dim, rope_theta=cfg.rope_theta,
        lengths=lengths)
    return _mlp_residual(p, x, cfg)


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random parameters on ``gen.device`` with the reference's shapes,
    scales and tree (layers stacked ``[L, ...]``)."""
    _check_supported(cfg)
    dt = model_dtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt)}
    params["layers"] = _stack([block_init(gen, cfg)
                               for _ in range(cfg.n_layers)])
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
    """Stacked per-layer KV state ``{"k","v"}: [L, batch, cache_len, n_kv,
    hd]``; a paged pool passes (arena pages, page_len)."""
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=model_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=model_dtype(cfg), device=device)}


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

def _arena(states, i: int):
    return {"k": states["k"][i], "v": states["v"][i]}


def run_layers_decode(layers, x, states, cur_pos, cfg: ModelConfig,
                      block_table):
    """One-token decode through a group of layers; ``states`` (stacked
    arenas of the same layers) update in place. Returns x."""
    for i in range(states["k"].shape[0]):
        x = block_apply_decode(layer_slice(layers, i), x, _arena(states, i),
                               cur_pos, cfg, block_table)
    return x


def run_layers_prefill(layers, x, positions, states, cfg: ModelConfig,
                       lengths=None, block_table=None):
    """Full-sequence pass through a group of layers that scatters every
    layer's K/V into its arena (in place). Returns x."""
    for i in range(states["k"].shape[0]):
        x = block_apply_prefill(layer_slice(layers, i), x, positions,
                                _arena(states, i), cfg, lengths, block_table)
    return x
