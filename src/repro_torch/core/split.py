"""Split-model wrapper: cut the model at ``cfg.split.split_at`` into a
UE-side encoder and an edge-side decoder, with the paper's selectable
bottleneck modes at the boundary (mirrors ``repro.core.split``: the
full-sequence split forward that training runs, the per-mode decode step
and prefill, and the mixed-mode ones).

``split_forward`` equals the full model's forward in mode 0 (the boundary
crosses raw); mode m >= 1 routes the boundary through bottleneck head m
(down-projection, quantization, the wire, dequantization, the up-projection
adapter), the phase-2 network of Algorithm 1.

Decode state (the paged arena, stacked dense caches, or a tuple of
per-layer states) is split along its layer axis into views, so both halves
update the pool in place and every step returns the state it was given:
the halves need no merge (the reference's ``_merge_states``, which
concatenates new functional halves, has no counterpart here).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bottleneck
from repro_torch.models import sharding
from repro_torch.models import transformer as T


def init_split_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Full model params + the bottleneck mode bank, on ``gen.device``."""
    params = T.init_params(gen, cfg)
    params["bneck_modes"] = bottleneck.bank_init(gen, cfg,
                                                 dtype=T.model_dtype(cfg))
    return params


def abstract_split_params(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_split_params``' tree for ``cfg`` as fake tensors: the init
    run without storage, each leaf's shape and dtype only (the reference's
    ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return init_split_params(torch.Generator(), cfg)


@functools.lru_cache(maxsize=64)
def param_shapes(cfg: ModelConfig) -> Tuple[Tuple[str, Tuple[int, ...],
                                                 torch.dtype], ...]:
    """(path, shape, dtype) of each leaf of ``abstract_split_params(cfg)``:
    the whole tree a mesh's layout reads (``sharding.rank_specs``) where
    only a rank's slices are at hand. Cached."""
    return sharding.tree_shapes(abstract_split_params(cfg))


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


# ---------------------------------------------------------------------------
# full-sequence split forward (training)
# ---------------------------------------------------------------------------

def encoder_apply(params, tokens, cfg: ModelConfig, mode: int, *,
                  train: bool = False, embeddings=None, plan=None):
    """UE side. Returns (payload, aux, info); the payload crosses the link:
    mode 0 the raw boundary activation and None; mode m the int codes and
    f32 scales of head m (under ``train``, its straight-through
    fake-quantized code and None). ``embeddings``: a vision prefix,
    embedded before the text as in ``T.forward``. ``info``: the positions
    and the wire bytes (of the embedded sequence, prefix included).
    ``plan``: a mesh's ``RankPlan`` (``cfg`` the rank's config)."""
    s = cfg.split.split_at
    x = T.embed_tokens(params, tokens, cfg, embeddings)
    B, S = x.shape[:2]
    positions = T.seq_positions(x)
    enc, _ = slice_layers(params["layers"], cfg, s)
    x, aux = T.run_layers(enc, x, positions, cfg, train=train,
                          kinds=_kinds(cfg)[:s], plan=plan)
    if mode == 0:
        payload = (x, None)
    else:
        _, bits = bottleneck.mode_widths(cfg.split)[mode - 1]
        payload = bottleneck.encode(params["bneck_modes"][mode - 1], x, bits,
                                    train=train)
    info = {"positions": positions,
            "payload_bytes": bottleneck.mode_payload_bytes(cfg, B, S, mode)}
    return payload, aux, info


def decoder_apply(params, payload, positions, cfg: ModelConfig, mode: int, *,
                  train: bool = False, plan=None):
    """Edge side: the adapter (mode >= 1), the remaining layers and the
    head. Returns (logits float32, aux)."""
    s = cfg.split.split_at
    codes, scales = payload
    if mode == 0:
        x = codes
    else:
        _, bits = bottleneck.mode_widths(cfg.split)[mode - 1]
        x = bottleneck.decode(params["bneck_modes"][mode - 1], codes, scales,
                              bits, dtype=T.model_dtype(cfg))
    _, dec = slice_layers(params["layers"], cfg, s)
    x, aux = T.run_layers(dec, x, positions, cfg, train=train,
                          kinds=_kinds(cfg)[s:], plan=plan)
    x = T.norm_apply_final(params, x, cfg)
    return T.lm_logits(params, x, cfg), aux


def split_forward(params, tokens, cfg: ModelConfig, mode: int = 0, *,
                  train: bool = False, embeddings=None, plan=None):
    """End-to-end split forward (the wire is identity on the payload's
    values; its bytes are in ``info``). ``plan``: a mesh's ``RankPlan``.
    Returns (logits, aux, info)."""
    params = sharding.fsdp_gather_top(params, plan)
    payload, aux1, info = encoder_apply(params, tokens, cfg, mode,
                                        train=train, embeddings=embeddings,
                                        plan=plan)
    logits, aux2 = decoder_apply(params, payload, info["positions"], cfg,
                                 mode, train=train, plan=plan)
    return logits, aux1 + aux2, info


# ---------------------------------------------------------------------------
# decode-time split (one token across the link per step)
# ---------------------------------------------------------------------------

def _wire(params, x, cfg: ModelConfig, mode: int):
    """The per-mode wire crossing: mode 0 sends the raw boundary
    activation; mode m >= 1 encodes through head m (rmsnorm, down-projection,
    quantization) and decodes on the edge (dequantization, up-projection)
    with the reference's plain ops."""
    if mode == 0:
        return x
    head = params["bneck_modes"][mode - 1]
    _, bits = bottleneck.mode_widths(cfg.split)[mode - 1]
    codes, scales = bottleneck.encode(head, x, bits)
    return bottleneck.decode(head, codes, scales, bits,
                             dtype=T.model_dtype(cfg))


def split_decode_step(params, token, states, cur_pos, cfg: ModelConfig,
                      mode: int = 0, return_tokens: bool = False, plan=None):
    """One-token decode with the boundary activation crossing the link in
    bottleneck ``mode`` (the whole batch on one mode). Encoder-side layer
    states stay on the UE, decoder-side ones at the edge; both update in
    place. token: [B, 1] ([B, K, 1] audio); ``cur_pos``: one int for
    aligned rows or a [B] tensor. Returns (logits [B, 1, V] ([B, K, 1, V]
    audio), states, payload_bytes); with ``return_tokens`` the decode tail
    (``T.decode_tail_tokens``) replaces the logits with argmax int32
    tokens shaped like ``token``. ``plan``: a serving mesh's ``RankPlan``
    (``cfg`` the rank's config)."""
    s = cfg.split.split_at
    x = T.embed_tokens(params, token, cfg)
    B = x.shape[0]
    pos = T.batch_positions(cur_pos, B, x.device)
    enc_l, dec_l = slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = _split_states(states, cfg, s)
    kinds = _kinds(cfg)
    x = T.run_layers_decode(enc_l, x, enc_st, pos, cfg, kinds=kinds[:s],
                            plan=plan)
    x = _wire(params, x, cfg, mode)
    x = T.run_layers_decode(dec_l, x, dec_st, pos, cfg, kinds=kinds[s:],
                            plan=plan)
    pb = bottleneck.mode_payload_bytes(cfg, B, 1, mode)
    if return_tokens:
        return T.decode_tail_tokens(params, x, cfg), states, pb
    x = T.norm_apply_final(params, x, cfg)
    return T.lm_logits(params, x, cfg), states, pb


def split_decode_step_mixed(params, stacked_bank, token, states, positions,
                            cfg: ModelConfig, mode_idx, block_table=None,
                            return_tokens: bool = False, mesh=None,
                            plan=None):
    """One decode step for a mixed-mode continuous batch: every slot at its
    own depth (``positions`` [B]) and through its own bottleneck
    (``mode_idx`` [B]: 0 = raw code z, m >= 1 = head m-1 of
    ``stacked_bank``). ``states`` update in place: the paged arena with
    ``block_table`` ([B, nb]), the dense per-slot state without.
    token: [B, 1] ([B, K, 1] audio). Returns (logits [B, 1, V] ([B, K, 1,
    V] audio), states); with ``return_tokens`` the decode tail replaces
    the logits with argmax int32 tokens shaped like ``token``.

    ``mesh``: a serving mesh (the boundary then runs as
    ``ops.boundary_mixed_sharded``); ``plan``: its ``RankPlan``, ``cfg``
    then the rank's config."""
    s = cfg.split.split_at
    x = T.embed_tokens(params, token, cfg)
    enc_l, dec_l = slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = _split_states(states, cfg, s)
    kinds = _kinds(cfg)
    x = T.run_layers_decode(enc_l, x, enc_st, positions, cfg,
                            kinds=kinds[:s], block_table=block_table, plan=plan)
    x = bottleneck.boundary_mixed(stacked_bank, x, mode_idx,
                                  dtype=T.model_dtype(cfg), mesh=mesh)
    x = T.run_layers_decode(dec_l, x, dec_st, positions, cfg,
                            kinds=kinds[s:], block_table=block_table, plan=plan)
    if return_tokens:
        return T.decode_tail_tokens(params, x, cfg), states
    x = T.norm_apply_final(params, x, cfg)
    return T.lm_logits(params, x, cfg), states


def _prefill_through(params, tokens, cfg: ModelConfig, states, boundary,
                     lengths, block_table, plan=None):
    """Whole-prompt prefill skeleton: encoder layers, ``boundary`` (the wire
    crossing), decoder layers, filling every layer's decode state.
    Returns (logits at each row's last real position [B, 1, V], states)."""
    s = cfg.split.split_at
    x = T.embed_tokens(params, tokens, cfg)
    positions = T.seq_positions(x)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=x.device)
    enc_l, dec_l = slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = _split_states(states, cfg, s)
    kinds = _kinds(cfg)
    x = T.run_layers_prefill(enc_l, x, positions, enc_st, cfg,
                             kinds=kinds[:s], lengths=lengths,
                             block_table=block_table, plan=plan)
    x = boundary(x)
    x = T.run_layers_prefill(dec_l, x, positions, dec_st, cfg,
                             kinds=kinds[s:], lengths=lengths,
                             block_table=block_table, plan=plan)
    return T.last_logits(params, x, lengths, cfg), states


def split_prefill(params, tokens, cfg: ModelConfig, states, mode: int = 0,
                  *, lengths=None):
    """Whole-prompt split prefill in one forward pass: encoder layers, the
    boundary through bottleneck ``mode`` (the prompt's single uplink
    transfer), decoder layers, filling every layer's decode state in place.
    tokens: [B, S] ([B, K, S] audio) right-padded; ``lengths``: optional
    [B] true lengths.
    Returns (last-real-position logits [B, 1, V], states, payload_bytes);
    the bytes cover the full padded [B, S] bucket, as in the reference."""
    logits, states = _prefill_through(
        params, tokens, cfg, states,
        lambda x: _wire(params, x, cfg, mode), lengths, None)
    pb = bottleneck.mode_payload_bytes(cfg, tokens.shape[0],
                                       tokens.shape[-1], mode)
    return logits, states, pb


def split_prefill_mixed(params, stacked_bank, tokens, states,
                        cfg: ModelConfig, mode_idx, *, lengths=None,
                        block_table=None, mesh=None, plan=None):
    """Batched multi-request prefill with per-row bottleneck modes: one
    forward over a right-padded prompt batch where row b's boundary
    activations cross the wire through its own mode. ``states``: the paged
    arena with ``block_table``, else a fresh dense state of the batch's
    rows. ``mesh`` / ``plan``: as in ``split_decode_step_mixed``; the batch
    runs replicated over dp (every rank of the mesh runs every row).
    Returns (last-real-position logits, states)."""
    return _prefill_through(
        params, tokens, cfg, states,
        lambda x: bottleneck.boundary_mixed(stacked_bank, x, mode_idx,
                                            dtype=T.model_dtype(cfg),
                                            mesh=mesh),
        lengths, block_table, plan)
