"""Phi-3.5-MoE 42B (6.6B active), 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,        # GQA kv=8
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    experts_per_tok=2,
    split=SplitConfig(split_at=16, d_bottleneck=1024, quant_bits=8),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, n_experts=4, experts_per_tok=2,
        split=SplitConfig(split_at=1, d_bottleneck=32, quant_bits=8))
