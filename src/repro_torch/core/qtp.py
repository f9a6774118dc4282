"""Quantized tensor-parallel prefill (mirrors ``repro.core.qtp``): the
paper's insight applied to the intra-layer tensor-parallel boundary.

Under Megatron's sequence-parallel schedule the residual stream crosses
the model group twice a layer (a gather before attention and before the
MLP, a reduce-scatter after each). This forward runs that schedule over a
training mesh's model ranks and quantizes the gathered operand to int8
(absmax codes and one float32 scale a row, ``core.quant``):

    x_loc [B, S/m, d]   (the sequence-sharded residual)
    norm -> quantize -> all_gather(model) -> dequantize -> the rank's heads
    or ffn slice -> partial sums [B, S, d] -> float32 reduce_scatter over
    the sequence -> + residual

``bits=0`` gathers the normed rows as they are (the exact-precision
schedule). The batch shards over the dp axes (``batch_pspec``), and the
weights over data where it is over 1 (FSDP: each layer gathered whole
just before use, ``sharding.fsdp_gather_layer``). It is a
forward only: the hidden states are gathered back (exactly) over the
sequence and the batch, and every rank computes the same logits.

Scope (``qtp_supported``): homogeneous attention stacks without experts
whose heads, KV heads, d_ff and sequence divide the model axis.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core import split as SP
from repro_torch.models import collectives as CL
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.models.attention import _attend
from repro_torch.models.layers import _act, apply_rope, norm_apply


def qtp_supported(cfg: ModelConfig, mesh, seq_len: int) -> bool:
    if mesh is None or "model" not in mesh.shape:
        return False
    m = mesh.shape["model"]
    return (cfg.homogeneous and not cfg.is_moe
            and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
            and seq_len % m == 0 and cfg.d_ff % m == 0)


def _qgather(x, bits: int, group):
    """quantize -> all_gather over the sequence -> dequantize. x: [B,
    S_loc, d]."""
    if bits == 0:
        return CL.gather_raw(x, group, 1)
    codes, scales = quant.quantize(x, bits)
    codes = CL.gather_raw(codes, group, 1)
    scales = CL.gather_raw(scales, group, 1)
    return quant.dequantize(codes, scales, bits).to(x.dtype)


def _block(lp, x_loc, pos, cfg: ModelConfig, m: int, bits: int, group):
    """One layer of the schedule on the rank's sequence block x_loc [Bl,
    S/m, d] with its heads' and ffn slice's weights."""
    Bl, S = pos.shape
    ql, kvl, hd = cfg.n_heads // m, cfg.n_kv_heads // m, cfg.head_dim
    mix = lp["mix"]
    # attention
    h = norm_apply(lp["norm1"], x_loc, cfg.norm)
    hg = _qgather(h, bits, group)                              # [Bl, S, d]
    q = (hg @ mix["wq"]["w"]).reshape(Bl, S, ql, hd)
    k = (hg @ mix["wk"]["w"]).reshape(Bl, S, kvl, hd)
    v = (hg @ mix["wv"]["w"]).reshape(Bl, S, kvl, hd)
    if "b" in mix["wq"]:
        q = q + mix["wq"]["b"].reshape(ql, hd)
        k = k + mix["wk"]["b"].reshape(kvl, hd)
        v = v + mix["wv"]["b"].reshape(kvl, hd)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    attn = _attend(q, k, v, pos, hd, cfg.sliding_window or cfg.local_window)
    part = attn.to(x_loc.dtype) @ mix["wo"]["w"]              # partial
    x_loc = x_loc + CL.scatter_sum_raw(part, group, 1).to(x_loc.dtype)
    # mlp
    mlp = lp["mlp"]
    h = norm_apply(lp["norm2"], x_loc, cfg.norm)
    hg = _qgather(h, bits, group)
    hh = _act(hg @ mlp["w_gate"]["w"], cfg.act) * (hg @ mlp["w_up"]["w"])
    part = hh @ mlp["w_down"]["w"]
    return x_loc + CL.scatter_sum_raw(part, group, 1).to(x_loc.dtype)


def qtp_forward(params, tokens, cfg: ModelConfig, *, mesh, bits: int = 8,
                embeddings=None) -> torch.Tensor:
    """Prefill forward with the quantized sequence-parallel schedule on a
    ``TrainMesh`` (``qtp_supported``). ``params``: the rank's tree
    (``sharding.shard_train_params``); ``tokens``: the global batch [B,
    S]. Returns the logits [B, S, V] of ``T.forward``'s contract without
    aux, the same on every rank."""
    m = mesh.shape["model"]
    group = mesh.group("model")
    plan = mesh.rank_plan(cfg, SP.param_shapes(cfg))
    params = sharding.fsdp_gather_top(params, plan)
    axes = sharding.batch_pspec(mesh, 2, tokens.shape[0])[0]
    axes = axes if axes and mesh.size(axes) > 1 else None
    batch = mesh.local_batch({"tokens": tokens} if embeddings is None else
                             {"tokens": tokens, "embeddings": embeddings},
                             axes)
    with torch.no_grad():
        x = T.embed_tokens(params, batch["tokens"], cfg,
                           batch.get("embeddings"))
        pos = T.seq_positions(x)
        s_loc = x.shape[1] // m
        lo = mesh.coords["model"] * s_loc
        x_loc = x[:, lo:lo + s_loc]
        for lp in T.unstack_layers(params["layers"]):
            lp = sharding.fsdp_gather_layer(lp, "attn", plan)
            x_loc = _block(lp, x_loc, pos, cfg, m, bits, group)
        x = CL.gather_raw(x_loc.contiguous(), group, 1)
        if axes is not None:
            x = CL.gather_raw(x, mesh.group(axes), 0)
        x = T.norm_apply_final(params, x, cfg)
        return T.lm_logits(params, x, cfg)
