"""Assigned input-shape registry (a copy of ``repro.configs.shapes``).

``train_*`` shapes run a train step; ``prefill_*`` a full-sequence
prefill; ``decode_*`` / ``long_*`` one decode step (ONE new token against
a KV cache or recurrent state of ``seq_len``). The dry run
(``repro_torch.launch.dryrun``) takes each of them at its full size.
"""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
