"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 2:1 pattern [arXiv:2402.19427].

Hybrid sub-quadratic arch — runs the ``long_500k`` shape with O(1) recurrent
state + O(window) local-attention cache. The split-learning boundary payload
for this family includes the RG-LRU recurrent state (beyond-paper extension
recorded in DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,        # MQA (GQA kv=1)
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    block_pattern=("rglru", "rglru", "attn"),   # Griffin 2 recurrent : 1 attn
    d_rnn=2560,
    local_window=2048,
    tie_embeddings=True,
    split=SplitConfig(split_at=12, d_bottleneck=640, quant_bits=8),
    source="arXiv:2402.19427",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, d_ff=256,
        vocab_size=512, head_dim=32, d_rnn=128, local_window=32,
        split=SplitConfig(split_at=2, d_bottleneck=32, quant_bits=8))
