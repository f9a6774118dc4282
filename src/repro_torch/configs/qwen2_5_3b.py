"""Qwen2.5-3B dense decoder with QKV bias and aggressive GQA [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,        # GQA kv=2
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    split=SplitConfig(split_at=18, d_bottleneck=512, quant_bits=8),
    source="hf:Qwen/Qwen2.5-0.5B",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
        vocab_size=512,
        split=SplitConfig(split_at=1, d_bottleneck=32, quant_bits=8))
