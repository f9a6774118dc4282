"""LLaVA-NeXT-34B VLM backbone [hf:llava-hf/llava-v1.6-mistral-7b-hf family].

anyres tiling: the SigLIP/ViT vision tower + projector is STUBBED per
assignment — ``input_specs`` provides precomputed patch embeddings of shape
(batch, n_vision_tokens, d_model) that the backbone consumes as a prefix
before the text tokens.
"""
from repro_torch.configs.base import ModelConfig, SplitConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,        # GQA kv=8
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    n_vision_tokens=576,  # one anyres base tile (24x24 patches)
    split=SplitConfig(split_at=30, d_bottleneck=1792, quant_bits=8),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=384,
        vocab_size=512, n_vision_tokens=16,
        split=SplitConfig(split_at=1, d_bottleneck=32, quant_bits=8))
