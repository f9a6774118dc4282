"""Analytic FLOP / HBM-byte models per (arch x shape): the numerators of
the dry run's roofline terms (the port's copy of
``repro.launch.analytic``, the same formulas and constants).

The reference keeps these because XLA's ``cost_analysis`` counts a loop
body once; the port has no such counter to correct, but its dry run
(``launch/dryrun.py``) still divides these numbers by the H100's peaks
(``launch/mesh.py``), so both packages' roofline tables read alike.

All formulas are FORWARD per-token per-layer; the step-level functions
apply the standard multipliers (train = fwd + 2x bwd + ~1x remat
recompute = 4x layers, 3x head; prefill = 1x; decode = 1x with T_eff =
cache length).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig, slstm_up_width
from repro_torch.models.xlstm import _MLSTM_PF

CAPACITY_FACTOR = 1.25     # must match models.moe default


# ---------------------------------------------------------------------------
# per-layer forward FLOPs per token
# ---------------------------------------------------------------------------

def _attn_layer_flops(cfg: ModelConfig, t_eff: int, group_n: int) -> float:
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * hd * (nq + 2 * nkv) + 2 * nq * hd * d
    attn = 4 * t_eff * nq * hd          # qk^T + pv (full blocks)
    return proj + attn + _mlp_flops(cfg, group_n)


def _mlp_flops(cfg: ModelConfig, group_n: int) -> float:
    if cfg.d_ff == 0:
        return 0.0
    if cfg.is_moe:
        k = cfg.experts_per_tok
        expert = 6 * cfg.d_model * cfg.d_ff * k
        # dispatch + combine einsums: 2 x (2 * E*C * d) per token,
        # E*C = k * cf * group_n
        dispatch = 4 * (k * CAPACITY_FACTOR * group_n) * cfg.d_model
        router = 2 * cfg.d_model * cfg.n_experts
        return expert + dispatch + router
    return 6 * cfg.d_model * cfg.d_ff


def _rglru_layer_flops(cfg: ModelConfig, group_n: int) -> float:
    d = cfg.d_model
    dr = cfg.d_rnn or d
    branches = 2 * 2 * d * dr            # in_gate + in_rec
    gates = 2 * 2 * dr * dr              # w_a + w_x
    conv_scan = 10 * dr                  # conv(4 taps) + recurrence update
    out = 2 * dr * d
    return branches + gates + conv_scan + out + _mlp_flops(cfg, group_n)


def _mlstm_layer_flops(cfg: ModelConfig) -> float:
    d = cfg.d_model
    di = int(_MLSTM_PF * d)
    hd = di // cfg.n_heads
    up = 2 * 2 * d * di
    qkv = 3 * 2 * di * di
    rec = 5 * di * hd                    # C update + Cq readout per head
    down = 2 * di * d
    return up + qkv + rec + down


def _slstm_layer_flops(cfg: ModelConfig) -> float:
    d = cfg.d_model
    hd = d // cfg.n_heads
    di = slstm_up_width(d)
    gates = 4 * 2 * d * d
    rec = 4 * 2 * d * hd                 # block-diagonal R per gate
    mlp = 2 * 2 * d * di + 2 * di * d
    return gates + rec + mlp


def fwd_flops_per_token(cfg: ModelConfig, t_eff: int, group_n: int) -> float:
    total = 0.0
    for layer in range(cfg.n_layers):
        kind = cfg.block_kind(layer)
        if kind == "attn":
            w = cfg.sliding_window or cfg.local_window
            total += _attn_layer_flops(cfg, min(t_eff, w) if w else t_eff,
                                       group_n)
        elif kind == "rglru":
            total += _rglru_layer_flops(cfg, group_n)
        elif kind == "mlstm":
            total += _mlstm_layer_flops(cfg)
        elif kind == "slstm":
            total += _slstm_layer_flops(cfg)
    return total


def head_flops_per_token(cfg: ModelConfig) -> float:
    k = cfg.n_codebooks if cfg.frontend == "audio" else 1
    return 2 * cfg.d_model * cfg.vocab_size * k


# ---------------------------------------------------------------------------
# step-level totals
# ---------------------------------------------------------------------------

def step_flops(cfg: ModelConfig, sc: ShapeConfig) -> float:
    """Total (all-device) FLOPs for one step of this shape."""
    if sc.kind == "decode":
        toks = sc.global_batch
        body = fwd_flops_per_token(cfg, sc.seq_len, group_n=1)
        return toks * (body + head_flops_per_token(cfg))
    toks = sc.global_batch * sc.seq_len
    body = fwd_flops_per_token(cfg, sc.seq_len, group_n=sc.seq_len)
    head = head_flops_per_token(cfg)
    if sc.kind == "train":
        return toks * (4.0 * body + 3.0 * head)
    return toks * (body + head)


@dataclass
class BytesModel:
    params: float
    activations: float
    kv_cache: float
    optimizer: float

    @property
    def total(self) -> float:
        return self.params + self.activations + self.kv_cache + self.optimizer


def step_hbm_bytes(cfg: ModelConfig, sc: ShapeConfig, chips: int,
                   model_shard: int = 16, kv_bits: int = 0) -> BytesModel:
    """Per-DEVICE HBM traffic for one step (coarse, documented model):

    - params: each device reads its TP shard of every weight once per pass
      (train: fwd + remat-fwd + bwd = 3 passes, bf16), MoE scaled to active
      experts' share of traffic (all experts touched across the batch).
    - optimizer: adam m/v read+write fp32 + param shard read+write (train).
    - activations: ~12 resident tensor passes of [tokens_dev, d] per layer
      (norms, projections in/out, residual adds) + blocked-attention KV
      re-reads (S / block_q passes over K,V per batch row).
    - kv_cache (decode): read full cache shard + write one slot per layer.
    """
    P = cfg.param_count()
    dev_tokens = (sc.global_batch * (1 if sc.kind == "decode" else sc.seq_len)
                  ) / max(chips // model_shard, 1)
    p_shard = 2.0 * P / model_shard            # bf16 bytes per full TP pass
    d = cfg.d_model

    if sc.kind == "decode":
        params = p_shard                        # one forward pass
        act = 12 * dev_tokens * d * 2 * cfg.n_layers
        kv = 0.0
        for layer in range(cfg.n_layers):
            kind = cfg.block_kind(layer)
            if kind == "attn":
                w = cfg.sliding_window or cfg.local_window
                t = min(sc.seq_len, w) if w else sc.seq_len
                # bytes/elt: bf16 = 2; int8 cache = 1 + scales (4/hd per elt)
                bpe = 2.0 if kv_bits == 0 else \
                    kv_bits / 8.0 + 4.0 / cfg.head_dim
                kv += (sc.global_batch / max(chips // model_shard, 1)) * \
                    t * cfg.n_kv_heads * cfg.head_dim * bpe * 2 / \
                    (model_shard if cfg.n_kv_heads % model_shard == 0 else 1)
            elif kind == "mlstm":
                di = int(_MLSTM_PF * d)
                hd = di // cfg.n_heads
                kv += sc.global_batch / max(chips // model_shard, 1) * \
                    cfg.n_heads * hd * hd * 4 * 2
        return BytesModel(params, act, kv, 0.0)

    passes = 3.0 if sc.kind == "train" else 1.0
    params = passes * p_shard
    opt = (20.0 * P / chips) if sc.kind == "train" else 0.0   # m,v rw + p rw
    act_passes = 12 * (4 if sc.kind == "train" else 1)
    act = act_passes * dev_tokens * d * 2 * cfg.n_layers
    # blocked attention K/V re-reads
    attn_layers = sum(1 for i in range(cfg.n_layers)
                      if cfg.block_kind(i) == "attn")
    if attn_layers and sc.seq_len >= 2048:
        n_qblocks = sc.seq_len / 512
        rows_dev = sc.global_batch / max(chips // model_shard, 1)
        kv_bytes = (sc.seq_len * cfg.n_kv_heads * cfg.head_dim * 2 * 2
                    / model_shard)
        act += attn_layers * rows_dev * n_qblocks * kv_bytes * \
            (4 if sc.kind == "train" else 1)
    return BytesModel(params, act, 0.0, opt)
