"""Split-model wrapper: cut the model at ``cfg.split.split_at`` into a
UE-side encoder and an edge-side decoder, with the paper's selectable
bottleneck modes at the boundary (mirrors the mixed-mode serving parts of
``repro.core.split``).

Decode state (the paged arena, stacked dense caches, or a tuple of
per-layer states) is split along its layer axis into views, so both halves
update the pool in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bottleneck
from repro_torch.models import transformer as T


def init_split_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Full model params + the bottleneck mode bank, on ``gen.device``."""
    params = T.init_params(gen, cfg)
    params["bneck_modes"] = bottleneck.bank_init(gen, cfg,
                                                 dtype=T.model_dtype(cfg))
    return params


def slice_layers(layers, cfg: ModelConfig, split_at: Optional[int] = None):
    """(encoder_layers, decoder_layers) views of the layer params."""
    s = split_at if split_at is not None else cfg.split.split_at
    if cfg.homogeneous:
        return (T.tree_map(lambda a: a[:s], layers),
                T.tree_map(lambda a: a[s:], layers))
    return layers[:s], layers[s:]


def _kinds(cfg: ModelConfig):
    return tuple(cfg.block_kind(i) for i in range(cfg.n_layers))


def _split_states(states, cfg: ModelConfig, s: int):
    """(encoder_states, decoder_states) views of the per-layer state."""
    if cfg.homogeneous:
        return (T.tree_map(lambda a: a[:s], states),
                T.tree_map(lambda a: a[s:], states))
    return states[:s], states[s:]


def split_decode_step_mixed(params, stacked_bank, token, states, positions,
                            cfg: ModelConfig, mode_idx, block_table=None,
                            return_tokens: bool = False):
    """One decode step for a mixed-mode continuous batch: every slot at its
    own depth (``positions`` [B]) and through its own bottleneck
    (``mode_idx`` [B]: 0 = raw code z, m >= 1 = head m-1 of
    ``stacked_bank``). ``states`` update in place: the paged arena with
    ``block_table`` ([B, nb]), the dense per-slot state without.
    Returns (logits [B, 1, V], states); with ``return_tokens`` the fused
    decode tail replaces the logits with argmax int32 tokens [B, 1]."""
    s = cfg.split.split_at
    x = T.embed_tokens(params, token, cfg)
    enc_l, dec_l = slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = _split_states(states, cfg, s)
    kinds = _kinds(cfg)
    x = T.run_layers_decode(enc_l, x, enc_st, positions, cfg,
                            kinds=kinds[:s], block_table=block_table)
    x = bottleneck.boundary_mixed(stacked_bank, x, mode_idx,
                                  dtype=T.model_dtype(cfg))
    x = T.run_layers_decode(dec_l, x, dec_st, positions, cfg,
                            kinds=kinds[s:], block_table=block_table)
    if return_tokens:
        return T.decode_tail_tokens(params, x, cfg), states
    x = T.norm_apply_final(params, x, cfg)
    return T.lm_logits(params, x, cfg), states


def _prefill_through(params, tokens, cfg: ModelConfig, states, boundary,
                     lengths, block_table):
    """Whole-prompt prefill skeleton: encoder layers, ``boundary`` (the wire
    crossing), decoder layers, filling every layer's decode state.
    Returns (logits at each row's last real position [B, 1, V], states)."""
    s = cfg.split.split_at
    x = T.embed_tokens(params, tokens, cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=x.device)
    enc_l, dec_l = slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = _split_states(states, cfg, s)
    kinds = _kinds(cfg)
    x = T.run_layers_prefill(enc_l, x, positions, enc_st, cfg,
                             kinds=kinds[:s], lengths=lengths,
                             block_table=block_table)
    x = boundary(x)
    x = T.run_layers_prefill(dec_l, x, positions, dec_st, cfg,
                             kinds=kinds[s:], lengths=lengths,
                             block_table=block_table)
    last = (lengths.long() - 1 if lengths is not None
            else torch.full((B,), S - 1, dtype=torch.long, device=x.device))
    x = x[torch.arange(B, device=x.device), last][:, None, :]
    x = T.norm_apply_final(params, x, cfg)
    return T.lm_logits(params, x, cfg), states


def split_prefill_mixed(params, stacked_bank, tokens, states,
                        cfg: ModelConfig, mode_idx, *, lengths=None,
                        block_table=None):
    """Batched multi-request prefill with per-row bottleneck modes: one
    forward over a right-padded prompt batch where row b's boundary
    activations cross the wire through its own mode. ``states``: the paged
    arena with ``block_table``, else a fresh dense state of the batch's
    rows. Returns (last-real-position logits, states)."""
    return _prefill_through(
        params, tokens, cfg, states,
        lambda x: bottleneck.boundary_mixed(stacked_bank, x, mode_idx,
                                            dtype=T.model_dtype(cfg)),
        lengths, block_table)
