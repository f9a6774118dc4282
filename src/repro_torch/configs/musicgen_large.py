"""MusicGen-Large decoder backbone over EnCodec tokens [arXiv:2306.05284].

The EnCodec conv codec / mel frontend is STUBBED per assignment:
``input_specs`` provides precomputed frame token ids per codebook; the model
embeds each of the 4 codebook streams and sums them (MusicGen's "delay"
interleave collapses to a sum of codebook embeddings at the backbone input).
"""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,        # MHA (GQA kv=32)
    d_ff=8192,
    vocab_size=2048,      # EnCodec codebook size
    act="gelu",
    norm="layernorm",
    frontend="audio",
    n_codebooks=4,
    split=SplitConfig(split_at=24, d_bottleneck=512, quant_bits=8,
                      extra_modes=((128, 8),)),
    source="arXiv:2306.05284",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, n_codebooks=2,
        split=SplitConfig(split_at=1, d_bottleneck=32, quant_bits=8))
