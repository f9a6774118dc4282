"""Mixtral-8x7B, 8 experts top-2, sliding-window attention [arXiv:2401.04088].

SWA (window 4096) makes decode over very long contexts O(window) — this arch
runs the ``long_500k`` shape with a rolling KV cache.
"""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,        # GQA kv=8
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_tok=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    split=SplitConfig(split_at=16, d_bottleneck=1024, quant_bits=8),
    source="arXiv:2401.04088",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, n_experts=4, experts_per_tok=2, sliding_window=64,
        split=SplitConfig(split_at=1, d_bottleneck=32, quant_bits=8))
