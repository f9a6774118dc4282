"""Symmetric row-wise latent-code quantization for the transmitted
bottleneck payload (mirrors ``repro.core.quant``).

int4 values are stored one-per-int8; ``payload_bytes`` accounts for the
packed wire format either way, since byte accounting is what the
orchestrator consumes.
"""
from __future__ import annotations

import math

import torch


def qmax(bits: int) -> int:
    """127 for int8, 7 for int4 — floored at 1 so ``bits=1`` maps to the
    ternary {-1, 0, 1} code instead of a zero qmax."""
    return max((1 << (bits - 1)) - 1, 1)


def quantize(x, bits: int = 8):
    """Row-wise symmetric quantization over the last dim.

    x: [..., d] float -> (codes int8 [..., d], scales f32 [..., 1]).
    ``torch.round`` rounds half to even, like ``jnp.round``.
    """
    if bits == 0:
        return x, None
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / qmax(bits)
    q = torch.clamp(torch.round(xf / scale), -qmax(bits), qmax(bits))
    return q.to(torch.int8), scale


def dequantize(q, scale, bits: int = 8):
    if bits == 0:
        return q
    return q.float() * scale


def payload_bytes(shape, bits: int, dtype_bytes: int = 2) -> int:
    """Wire bytes for a latent of ``shape`` ([..., d]): packed codes +
    one fp16 scale per row (bits==0 -> raw bf16 payload). Codes pack per
    row; ``bits=1`` (ternary) is charged the 2-bit packing."""
    n = math.prod(shape)
    if bits == 0:
        return n * dtype_bytes
    eff_bits = max(bits, 2)
    rows = n // shape[-1]
    return rows * math.ceil(shape[-1] * eff_bits / 8) + rows * 2
