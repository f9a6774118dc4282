"""Decoder-only transformer for every arch family of the reference
(mirrors ``repro.models.transformer``): homogeneous attention stacks
(dense GQA; mixture of experts, whose blocks route through
``models.moe``; and the frontend archs: MusicGen's summed codebook
embeddings with one LM head a codebook, LLaVA's vision prefix
concatenated before the text) and heterogeneous block patterns
(RecurrentGemma's RG-LRU and local-attention blocks, xLSTM's alternating
mLSTM and sLSTM blocks). Under a training mesh's ``moe_ep`` flag
(``sharding.activation_rules``) a MoE block runs the expert-parallel
schedule (``models.moe_ep``), as the reference's does.

Every runner takes a mesh's ``RankPlan`` (``plan``: the model group of
each sharded block kind; ``cfg`` then holds the rank's head counts and
widths): the attention, MLP, MoE, RG-LRU and xLSTM blocks run Megatron's
tensor-parallel split, their input's gradient summed over the group and
their output summed in float32 (``models.collectives``). On a training
mesh with a data axis over 1 each layer first gathers its data-split
weights (``sharding.fsdp_gather``, the reference's FSDP). Under ``train``
a layer's recomputation replays its collectives (the gathers too), in the
same order on every rank.

Homogeneous archs keep stacked ``[L, ...]`` layer leaves, and the layer
runners loop over per-layer slices (views, no copies) where the reference
scans; heterogeneous archs keep a tuple of per-layer trees, as the
reference does. The full-sequence runner (``run_layers``, which
``forward`` and the split forward train through) takes the per-layer
views of each stacked leaf from one ``torch.unbind``, whose backward is
one ``stack``: indexing a leaf once a layer would give each layer's
backward a zero tensor the size of the whole stack. Under ``train`` it
recomputes each layer in the backward, as the reference's
``jax.checkpoint`` does. Decode state is updated in place: the paged arena
``{"k", "v"}`` of ``[L, n_pages, page_len, n_kv, hd]`` leaves, stacked
dense rolling caches ``[L, B, cache_len, n_kv, hd]`` (or the int8
cache's codes and scales, ``kv_bits=8``), or a tuple of per-layer states
(rolling caches, RG-LRU and xLSTM carries).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attn_init, decode_attention,
                                          full_attention, init_cache,
                                          paged_decode_attention,
                                          paged_prefill_attention,
                                          prefill_attention)
from repro_torch.models.layers import (dense_init, embed_apply, embed_init,
                                       embed_logits, mlp_apply, mlp_init,
                                       norm_apply, norm_init)
from repro_torch.models import sharding
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.moe_ep import moe_apply_ep, moe_supports_ep
from repro_torch.models.rglru import (rglru_full, rglru_init, rglru_prefill,
                                      rglru_prepare, rglru_state_init,
                                      rglru_step)
from repro_torch.models.scan_utils import remat
from repro_torch.models.xlstm import (mlstm_full, mlstm_init, mlstm_prefill,
                                      mlstm_state_init, mlstm_step,
                                      slstm_full, slstm_init, slstm_prefill,
                                      slstm_prepare, slstm_state_init,
                                      slstm_step)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_NO_PLAN = sharding.RankPlan()
_KINDS = ("attn", "rglru", "mlstm", "slstm")


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


def unstack_layers(layers) -> list:
    """The per-layer trees of stacked ``[L, ...]`` leaves (nested dicts):
    views from one ``torch.unbind`` a leaf, so the backward of all of
    them is one ``stack`` a leaf."""
    if isinstance(layers, dict):
        parts = {k: unstack_layers(v) for k, v in layers.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(layers, 0))


def _kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    return tuple(cfg.block_kind(i) for i in range(cfg.n_layers))


def _check_supported(cfg: ModelConfig):
    if not set(_kinds(cfg)) <= set(_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: repro_torch runs attention, RG-LRU, mLSTM and "
            f"sLSTM blocks only")


def multi_codebook(cfg: ModelConfig) -> bool:
    """Audio archs with several codebooks: K stacked embedding tables and
    LM heads, tokens [B, K, S]."""
    return cfg.frontend == "audio" and cfg.n_codebooks > 1


def _attn_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window or cfg.local_window


def full_attention_arch(cfg: ModelConfig) -> bool:
    """True if any layer attends the full context (no window): the KV cache
    is addressed by absolute position, so serving must keep
    ``prompt_len + max_new_tokens <= cache_len``."""
    return (not _attn_window(cfg)) and any(
        cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))


def check_cache_capacity(cfg: ModelConfig, pos: int, n: int, cache_len: int,
                         what: str = "generation") -> None:
    """The full-attention capacity rule of the dense serving entry points
    (the sync engine's prefill and decode, the launcher's static loop):
    ``pos + n`` must not exceed ``cache_len``, or the rolling write would
    evict early prompt context. Windowed and recurrent archs wrap by design
    and always pass. Raises ``ValueError``."""
    if full_attention_arch(cfg) and pos + n > cache_len:
        raise ValueError(
            f"{what} of {n} tokens from position {pos} exceeds cache_len "
            f"{cache_len} for a full-attention arch (the rolling cache "
            f"would overwrite prompt context)")


def batch_positions(cur_pos, batch: int, device):
    """Per-row decode positions [B] int32: ``cur_pos`` as given when it is
    already a [B] tensor, else one int (all rows aligned, as in synchronous
    batched serving) broadcast to every row."""
    if torch.is_tensor(cur_pos) and cur_pos.dim() == 1:
        return cur_pos
    return torch.full((batch,), int(cur_pos), dtype=torch.int32,
                      device=device)


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
    elif kind == "mlstm":
        p["mix"] = mlstm_init(gen, cfg.d_model, cfg.n_heads, dtype=dt)
    elif kind == "slstm":
        p["mix"] = slstm_init(gen, cfg.d_model, cfg.n_heads, dtype=dt)
    else:
        raise ValueError(kind)
    if kind in ("attn", "rglru") and cfg.d_ff:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dtype=dt,
                               device=gen.device)
        if cfg.is_moe:
            p["mlp"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                dtype=dt)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dt)
    return p


def _mlp_residual(p, x, cfg: ModelConfig, group=None):
    """The block's MLP (dense, or the MoE layer) on its residual: (x, aux
    loss), the aux MoE's 0-d float32 load-balance loss, None without
    experts. ``group``: the model group the MLP (or the experts) split
    over. Under the ``moe_ep`` flag with a training mesh whose layout
    takes it (``moe_supports_ep``), a MoE layer runs ``moe_apply_ep``."""
    aux = None
    if "mlp" in p:
        h = norm_apply(p["norm2"], x, cfg.norm)
        mesh = sharding.ctx_mesh()
        if cfg.is_moe and sharding.ctx_flag("moe_ep") and moe_supports_ep(
                cfg.n_experts, mesh, sharding.ctx_rule("batch", h.shape[0]),
                h.shape[1]):
            m, aux = moe_apply_ep(p["mlp"], h, k=cfg.experts_per_tok,
                                  act=cfg.act, mesh=mesh)
        elif cfg.is_moe:
            m, aux = moe_apply(p["mlp"], h, k=cfg.experts_per_tok,
                               act=cfg.act, group=group)
        else:
            m = mlp_apply(p["mlp"], h, cfg.act, group)
        x = x + m
    return x, aux


def _attn_dims(cfg: ModelConfig):
    return dict(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.head_dim,
                rope_theta=cfg.rope_theta)


def block_apply_full(p, x, positions, cfg: ModelConfig, kind: str = "attn",
                     train: bool = False, plan=None):
    """Full-sequence block, no decode state. Returns (x, aux_loss), the
    aux loss MoE's load-balance loss (a 0-d float32 zero without
    experts). ``train`` keeps the recurrent families on their cell scans
    (the CUDA scan has no backward); eval routes RG-LRU and the mLSTM
    normalizer through ``ops.rglru_scan_op``. ``plan``: a mesh's
    ``RankPlan`` (``cfg`` the rank's config); with a data group the
    block's data-split weights are gathered whole first."""
    p = sharding.fsdp_gather_layer(p, kind, plan)
    plan = plan or _NO_PLAN
    g = plan.group(kind)
    h = norm_apply(p["norm1"], x, cfg.norm)
    if kind == "attn":
        mix = full_attention(p["mix"], h, positions, window=_attn_window(cfg),
                             group=g, **_attn_dims(cfg))
    elif kind == "rglru":
        mix = rglru_full(p["mix"], h, train=train, group=g)
    elif kind == "mlstm":
        mix = mlstm_full(p["mix"], h, cfg.n_heads, train=train, group=g)
    elif kind == "slstm":
        mix = slstm_full(p["mix"], h, cfg.n_heads, group=g)
    else:
        raise ValueError(kind)
    x, aux = _mlp_residual(p, x + mix, cfg, plan.mlp)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def block_apply_decode(p, x, state, cur_pos, cfg: ModelConfig,
                       kind: str = "attn", block_table=None, plan=None):
    """One-token decode through one block; ``state`` (its paged arena,
    rolling cache, RG-LRU or xLSTM carry) updates in place. ``plan``: the
    serving mesh's ``RankPlan`` (its mp groups; ``cfg`` then holds the
    rank's head counts). Returns x (a MoE layer's aux loss is dropped, as
    in the reference)."""
    plan = plan or _NO_PLAN
    g = plan.group(kind)
    h = norm_apply(p["norm1"], x, cfg.norm)
    if kind == "attn" and block_table is not None:
        mix = paged_decode_attention(p["mix"], h, state, block_table,
                                     cur_pos, group=g, **_attn_dims(cfg))
    elif kind == "attn":
        mix = decode_attention(p["mix"], h, state, cur_pos,
                               window=_attn_window(cfg), group=g,
                               **_attn_dims(cfg))
    elif kind == "rglru":
        mix = rglru_step(p["mix"], h, state, group=g)
    elif kind == "mlstm":
        mix = mlstm_step(p["mix"], h, state, cfg.n_heads, group=g)
    elif kind == "slstm":
        mix = slstm_step(p["mix"], h, state, cfg.n_heads, group=g)
    else:
        raise ValueError(kind)
    return _mlp_residual(p, x + mix, cfg, plan.mlp)[0]


def block_apply_prefill(p, x, positions, state, cfg: ModelConfig,
                        kind: str = "attn", lengths=None, block_table=None,
                        plan=None):
    """Full-sequence block that also fills its decode state (in place):
    K/V rows into the arena through ``block_table`` or into the rolling
    cache, or the recurrent carry. ``plan`` as in ``block_apply_decode``.
    Returns x (a MoE layer's aux loss dropped)."""
    plan = plan or _NO_PLAN
    g = plan.group(kind)
    h = norm_apply(p["norm1"], x, cfg.norm)
    if kind == "attn" and block_table is not None:
        mix = paged_prefill_attention(p["mix"], h, positions, state,
                                      block_table, lengths=lengths,
                                      group=g, **_attn_dims(cfg))
    elif kind == "attn":
        mix = prefill_attention(p["mix"], h, positions, state,
                                window=_attn_window(cfg), lengths=lengths,
                                group=g, **_attn_dims(cfg))
    elif kind == "rglru":
        mix = rglru_prefill(p["mix"], h, state, lengths=lengths, group=g)
    elif kind == "mlstm":
        mix = mlstm_prefill(p["mix"], h, state, cfg.n_heads, lengths=lengths,
                            group=g)
    elif kind == "slstm":
        mix = slstm_prefill(p["mix"], h, state, cfg.n_heads, lengths=lengths,
                            group=g)
    else:
        raise ValueError(kind)
    return _mlp_residual(p, x + mix, cfg, plan.mlp)[0]


def block_state_init(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     device=None, kv_bits: int = 0, mp: int = 1):
    """One block's zero decode state; ``mp``: one rank's share where the
    block kind splits over ``mp`` model ranks (its KV heads, RG-LRU
    channels, mLSTM heads or sLSTM channels)."""
    dt = model_dtype(cfg)
    n = mp if sharding.check_model_parallel(cfg, mp)[kind] else 1
    if kind == "attn":
        w = _attn_window(cfg)
        clen = min(cache_len, w) if w else cache_len
        return init_cache(batch, cfg.n_kv_heads // n, cfg.head_dim, clen,
                          dtype=dt, kv_bits=kv_bits, device=device)
    if kind == "rglru":
        return rglru_state_init(batch, (cfg.d_rnn or cfg.d_model) // n,
                                dtype=dt, device=device)
    if kind == "mlstm":
        return mlstm_state_init(batch, cfg.d_model, cfg.n_heads,
                                device=device, shards=n)
    if kind == "slstm":
        return slstm_state_init(batch, cfg.d_model // n, device=device)
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
    K = cfg.n_codebooks
    params: Dict[str, Any] = {}
    if multi_codebook(cfg):             # K tables [K, V, d]
        params["embed"] = _stacked(lambda: embed_init(
            gen, cfg.vocab_size, cfg.d_model, dtype=dt), K)
    else:
        params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                     dtype=dt)
    if cfg.homogeneous:
        params["layers"] = _stacked(
            lambda: block_init(gen, cfg, cfg.block_kind(0)), cfg.n_layers)
    else:
        params["layers"] = tuple(block_init(gen, cfg, cfg.block_kind(i))
                                 for i in range(cfg.n_layers))
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dtype=dt,
                                     device=gen.device)
    if multi_codebook(cfg):             # K heads [K, d, V]
        params["lm_head"] = _stacked(lambda: dense_init(
            gen, cfg.d_model, cfg.vocab_size, dtype=dt), K)
    elif not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype=dt)
    return params


_PREPARE = {"rglru": rglru_prepare, "slstm": slstm_prepare}


def prepare_params(params, cfg: ModelConfig) -> Dict[str, Any]:
    """``params`` with each RG-LRU and sLSTM layer's per-step float32 forms
    made once (``rglru_prepare``, ``slstm_prepare``), as the serving
    engines run them: a new top-level tree sharing every tensor of
    ``params``, which stays as it is. Trees without such layers come back
    unchanged."""
    kinds = _kinds(cfg)
    if not set(kinds) & set(_PREPARE):
        return params
    layers = tuple({**p, "mix": _PREPARE[k](p["mix"])} if k in _PREPARE
                   else p for p, k in zip(params["layers"], kinds))
    return {**params, "layers": layers}


def _stacked(draw, n: int):
    """``n`` trees from ``draw()`` (a layer's block, a codebook's table or
    head) as stacked ``[n, ...]`` leaves, drawn in order (the numbers
    ``torch.stack`` of the trees holds) and written into the stack as each
    is made, so the peak is the stack plus one tree."""
    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    first = draw()
    stack = tree_map(lambda a: a.new_empty((n,) + a.shape), first)
    put(stack, first, 0)
    del first
    for i in range(1, n):
        put(stack, draw(), i)
    return stack


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int,
                      device=None, kv_bits: int = 0, mp: int = 1):
    """Per-layer decode state: stacked ``{"k","v"}: [L, batch, clen, n_kv,
    hd]`` for homogeneous archs (a paged pool passes (arena pages,
    page_len)), a tuple of per-layer states otherwise. ``kv_bits=8``: the
    int8 rolling cache (codes and scales), in the attention blocks only.
    ``mp``: one rank's share on a mesh of ``mp`` model ranks (``cfg`` the
    whole config; ``sharding.shard_state`` cuts the same slices)."""
    if cfg.homogeneous:
        one = block_state_init(cfg, "attn", batch, cache_len, "meta",
                               kv_bits, mp)
        return tree_map(lambda a: torch.zeros((cfg.n_layers,) + a.shape,
                                              dtype=a.dtype, device=device),
                        one)
    return tuple(block_state_init(cfg, kind, batch, cache_len, device,
                                  kv_bits if kind == "attn" else 0, mp)
                 for kind in _kinds(cfg))


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig, embeddings=None):
    """tokens: [B, S] int (or [B, K, S] audio) -> [B, S, d]. Audio sums the
    K codebooks' rows in float32 and rounds once, as ``jnp.sum`` of the
    reference does. ``embeddings``: the stubbed vision frontend's output
    [B, Nv, d], cast to the model's dtype and put before the text (the
    sequence is then Nv + S long)."""
    if multi_codebook(cfg):
        table = params["embed"]["table"]                     # [K, V, d]
        k = torch.arange(table.shape[0], device=tokens.device)[:, None]
        x = table[k, tokens.long()].float().sum(dim=1).to(table.dtype)
    else:
        x = embed_apply(params["embed"], tokens.long())
    if cfg.tie_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.frontend == "vision" and embeddings is not None:
        x = torch.cat([embeddings.to(x.dtype), x], dim=1)
    return x


def norm_apply_final(params, x, cfg: ModelConfig):
    return norm_apply(params["final_norm"], x, cfg.norm)


def lm_logits(params, x, cfg: ModelConfig):
    """Logits in float32: the tied read-out (``embed_logits``), the LM
    head, or the K codebook heads ([B, K, S, V])."""
    if multi_codebook(cfg):
        return torch.einsum("bsd,kdv->bksv", x.float(),
                            params["lm_head"]["w"].float())
    if cfg.tie_embeddings:
        return embed_logits(params["embed"], x)
    return x.float() @ params["lm_head"]["w"].float()


def decode_tail_tokens(params, x, cfg: ModelConfig):
    """Fused decode tail: final norm -> LM head -> argmax in one kernel on
    CUDA (``ops.decode_tail_op``); on the CPU its serving reference, which
    is expression-identical to the norm / lm_logits / argmax chain.
    Multi-codebook audio heads keep that chain on every device, as the
    reference does (a codebook's argmax is not one head's).
    x: [B, S, d] decoder output (pre final norm). Returns int32 [B, S]
    ([B, K, S] audio)."""
    if multi_codebook(cfg):
        xn = norm_apply_final(params, x, cfg)
        return torch.argmax(lm_logits(params, xn, cfg), dim=-1).to(
            torch.int32)
    from repro_torch.kernels import ops
    fn = params["final_norm"]
    if cfg.tie_embeddings:
        heads, tied = params["embed"]["table"][None], True
    else:
        heads, tied = params["lm_head"]["w"][None], False
    return ops.decode_tail_op(x, fn["scale"], fn.get("bias"), heads,
                              norm_kind=cfg.norm, tied=tied)


# ---------------------------------------------------------------------------
# top-level forwards
# ---------------------------------------------------------------------------

def seq_positions(x):
    """Positions 0..S-1 of every row of x [B, S, ...]: [B, S] int32."""
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)


def forward(params, tokens, cfg: ModelConfig, *, train: bool = False,
            embeddings=None, plan=None):
    """Full-sequence forward. tokens: [B, S] int ([B, K, S] audio);
    ``embeddings``: a vision prefix [B, Nv, d]; ``plan``: a mesh's
    ``RankPlan``. Returns (logits [B, Nv + S, V] float32 ([B, K, S, V]
    audio), aux_loss)."""
    params = sharding.fsdp_gather_top(params, plan)
    x = embed_tokens(params, tokens, cfg, embeddings)
    x, aux = run_layers(params["layers"], x, seq_positions(x), cfg,
                        train=train, plan=plan)
    x = norm_apply_final(params, x, cfg)
    return lm_logits(params, x, cfg), aux


def lm_loss(logits, labels, mask=None):
    """Cross-entropy over the vocab axis; labels int [B, S] or [B, K, S].
    A 0-d float32 tensor: the mean, or the ``mask``-weighted mean."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def prefill(params, tokens, cfg: ModelConfig, states, lengths=None,
            embeddings=None, block_table=None, plan=None):
    """Batched full-sequence prefill: the whole prompt in one forward pass,
    filling ``states`` in place (KV rows at their rolling slots or, with
    ``block_table`` [B, nb], into the paged arena; recurrent carries
    advanced to each row's last real token). tokens: [B, S] ([B, K, S]
    audio), right-padded; a vision prefix ``embeddings`` is concatenated as
    in :func:`forward`, and ``lengths`` (optional [B] true lengths) then
    count the concatenated sequence. Returns (logits at each row's last
    real position, [B, 1, V] ([B, K, 1, V] audio), states)."""
    x = embed_tokens(params, tokens, cfg, embeddings)
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=x.device)
    x = run_layers_prefill(params["layers"], x, seq_positions(x), states,
                           cfg, lengths=lengths, block_table=block_table,
                           plan=plan)
    return last_logits(params, x, lengths, cfg), states


def last_logits(params, x, lengths, cfg: ModelConfig):
    """Logits [B, 1, V] ([B, K, 1, V] audio) at each row's last real
    position of a prefill's output x [B, S, d] (``lengths`` [B], or None:
    all S)."""
    B, S = x.shape[:2]
    last = (lengths.long() - 1 if lengths is not None
            else torch.full((B,), S - 1, dtype=torch.long, device=x.device))
    x = x[torch.arange(B, device=x.device), last][:, None, :]
    x = norm_apply_final(params, x, cfg)
    return lm_logits(params, x, cfg)


def decode_step(params, token, states, cur_pos, cfg: ModelConfig,
                return_tokens: bool = False, block_table=None, plan=None):
    """One new token against the decode state (updated in place): the dense
    state, or the paged arena through ``block_table`` [B, nb]. token:
    [B, 1] ([B, K, 1] audio); ``cur_pos``: one int for aligned rows or a
    [B] tensor. Returns (logits [B, 1, V] ([B, K, 1, V] audio), states);
    with ``return_tokens`` the decode tail replaces the logits with argmax
    int32 tokens shaped like ``token``."""
    x = embed_tokens(params, token, cfg)
    pos = batch_positions(cur_pos, x.shape[0], x.device)
    x = run_layers_decode(params["layers"], x, states, pos, cfg,
                          block_table=block_table, plan=plan)
    if return_tokens:
        return decode_tail_tokens(params, x, cfg), states
    x = norm_apply_final(params, x, cfg)
    return lm_logits(params, x, cfg), states


# ---------------------------------------------------------------------------
# layer runners (shared by the full model and the split encoder / decoder)
# ---------------------------------------------------------------------------

def run_layers(layers, x, positions, cfg: ModelConfig, *, train: bool,
               kinds: Optional[Tuple[str, ...]] = None, plan=None):
    """Full-sequence pass through a group of layers: ``layers`` stacked
    ``[L, ...]`` (homogeneous) or a tuple of per-layer trees. Under
    ``train`` each layer is recomputed in the backward. ``plan``: a mesh's
    ``RankPlan`` (``cfg`` the rank's config). Returns (x, aux_loss_sum),
    the sum a 0-d float32 tensor on x's device."""
    if cfg.homogeneous:
        per_layer = unstack_layers(layers)
        kinds = ("attn",) * len(per_layer)
    else:
        per_layer = layers
        kinds = kinds or _kinds(cfg)[:len(layers)]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in zip(per_layer, kinds):
        if train:
            x, a = remat(block_apply_full, lp, x, positions, cfg, kind, True,
                         plan)
        else:
            x, a = block_apply_full(lp, x, positions, cfg, kind, plan=plan)
        aux = aux + a
    return x, aux


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
                      block_table=None, plan=None):
    """One-token decode through a group of layers; ``states`` (the same
    layers' decode state) update in place. ``block_table`` (paged pool) is
    shared by every attention layer. ``plan``: a serving mesh's
    ``RankPlan`` (the mp groups the split blocks reduce over; ``cfg`` the
    rank's config). Returns x."""
    for lp, st, kind in _per_layer(layers, states, cfg, kinds):
        x = block_apply_decode(lp, x, st, cur_pos, cfg, kind, block_table,
                               plan)
    return x


def run_layers_prefill(layers, x, positions, states, cfg: ModelConfig,
                       kinds: Optional[Tuple[str, ...]] = None, lengths=None,
                       block_table=None, plan=None):
    """Full-sequence pass through a group of layers that fills every
    layer's decode state (in place); ``plan`` as in ``run_layers_decode``.
    Returns x."""
    for lp, st, kind in _per_layer(layers, states, cfg, kinds):
        x = block_apply_prefill(lp, x, positions, st, cfg, kind, lengths,
                                block_table, plan)
    return x
