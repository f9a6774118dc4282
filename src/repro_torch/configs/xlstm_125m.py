"""xLSTM-125M: alternating sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0 per the assignment — xLSTM blocks carry their own up/down projections
inside the block (pre-up-projection mLSTM, post-up-projection sLSTM); there is
no separate transformer MLP. Pure recurrent -> runs ``long_500k`` with O(1)
state.
"""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,        # (GQA kv=4) — heads of the mLSTM matrix memory
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),   # 1:1 alternation
    norm="layernorm",
    act="gelu",
    split=SplitConfig(split_at=6, d_bottleneck=192, quant_bits=8),
    source="arXiv:2405.04517",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        vocab_size=512,
        split=SplitConfig(split_at=1, d_bottleneck=32, quant_bits=8))
