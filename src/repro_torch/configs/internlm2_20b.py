"""InternLM2-20B dense decoder, GQA [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    arch_type="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,        # GQA kv=8
    d_ff=16384,
    vocab_size=92544,
    split=SplitConfig(split_at=24, d_bottleneck=1536, quant_bits=8),
    source="arXiv:2403.17297",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, d_ff=512,
        vocab_size=512,
        split=SplitConfig(split_at=1, d_bottleneck=48, quant_bits=8))
