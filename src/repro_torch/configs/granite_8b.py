"""Granite-8B-Code, llama-architecture dense decoder [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,        # GQA kv=8
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    split=SplitConfig(split_at=18, d_bottleneck=1024, quant_bits=8),
    source="arXiv:2405.04324",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
        vocab_size=512,
        split=SplitConfig(split_at=1, d_bottleneck=32, quant_bits=8))
