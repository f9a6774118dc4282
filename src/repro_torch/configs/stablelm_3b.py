"""StableLM-3B dense decoder [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    arch_type="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,       # GQA kv=32 (full MHA)
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    act="silu",
    split=SplitConfig(split_at=16, d_bottleneck=640, quant_bits=8),
    source="hf:stabilityai/stablelm-2-1_6b",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=320,
        vocab_size=512,
        split=SplitConfig(split_at=1, d_bottleneck=32, quant_bits=8))
