"""Bottleneck exit heads — the paper's added "layer A" (encoder side) and
"layer B" (decoder side), generalized to a bank of modes (mirrors
``repro.core.bottleneck``).

Mode 0 is always the phase-1 code z, the raw split-boundary activation.
Mode m >= 1 adds a down-projection (layer A) producing z' of width
``d_bottleneck_m``, quantized for the wire, and an up-projection adapter
(layer B) mapping the received code back into the decoder's input width.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SplitConfig
from repro_torch.core import quant
from repro_torch.models.layers import (dense_apply, dense_init, norm_apply,
                                       norm_init)


def mode_widths(split: SplitConfig) -> List[Tuple[int, int]]:
    """[(width, quant_bits)] for modes 1..M (mode 0 is the raw boundary)."""
    out = []
    if split.d_bottleneck:
        out.append((split.d_bottleneck, split.quant_bits))
    out.extend(split.extra_modes)
    return out


def head_init(gen, d_model: int, d_bneck: int, *, dtype=torch.bfloat16):
    return {
        "norm": norm_init(d_model, "rmsnorm", dtype=dtype, device=gen.device),
        "down": dense_init(gen, d_model, d_bneck, dtype=dtype),   # layer A
        "up": dense_init(gen, d_bneck, d_model, dtype=dtype),     # layer B
    }


def bank_init(gen, cfg: ModelConfig, *, dtype=torch.bfloat16):
    return tuple(head_init(gen, cfg.d_model, w, dtype=dtype)
                 for w, _ in mode_widths(cfg.split))


def encode(head, x, bits: int, *, train: bool = False):
    """Encoder-side transmit op (layer A + wire quantization).
    x: [..., d_model] -> (codes, scales), the payload that crosses the link.
    ``train=True`` returns the straight-through fake-quantized code and no
    scales (a float payload with the same forward values), so gradients
    reach layer A in cascade phase 2; serving keeps the int8 wire format."""
    z = dense_apply(head["down"], norm_apply(head["norm"], x, "rmsnorm"))
    if train and bits:
        return quant.ste_quantize(z, bits), None
    return quant.quantize(z, bits)


def decode(head, codes, scales, bits: int, dtype=torch.bfloat16):
    """Decoder-side receive op (dequant + layer B adapter)."""
    z = codes if scales is None else quant.dequantize(codes, scales, bits)
    return dense_apply(head["up"], z.to(dtype))


def bank_stack(bank, split: SplitConfig):
    """Pad every head to the widest bottleneck and stack the bank into
    [M, ...] tensors so one decode step gathers each slot's head. Columns
    (rows) past a head's true width are zero, so padded lanes carry exact
    zeros through quantization."""
    modes = mode_widths(split)
    if not bank:
        raise ValueError("bank_stack needs at least one bottleneck head")
    wmax = max(w for w, _ in modes)
    dev = bank[0]["down"]["w"].device
    return {
        "down_w": torch.stack([F.pad(h["down"]["w"], (0, wmax - w))
                               for h, (w, _) in zip(bank, modes)]),
        "up_w": torch.stack([F.pad(h["up"]["w"], (0, 0, 0, wmax - w))
                             for h, (w, _) in zip(bank, modes)]),
        "norm_scale": torch.stack([h["norm"]["scale"] for h in bank]),
        "width": torch.tensor([w for w, _ in modes], dtype=torch.int32,
                              device=dev),
        "bits": torch.tensor([b for _, b in modes], dtype=torch.int32,
                             device=dev),
    }


def boundary_mixed(stacked, x, mode_idx, *, dtype=torch.bfloat16,
                   mesh=None):
    """Per-slot bottleneck at the split boundary.

    x: [B, S, d] boundary activation; mode_idx: [B] int32 in [0, M] (0 =
    raw code z, m >= 1 = head m-1 of the stacked bank). Returns the
    decoder-side activation [B, S, d]. On CUDA tensors this runs the
    hand-written boundary kernel; on CPU tensors its plain PyTorch version
    (``kernels.ops.boundary_mixed_op``). ``mesh``: a serving mesh, on whose
    ranks it runs as ``ops.boundary_mixed_sharded``."""
    from repro_torch.kernels import ops
    if mesh is not None:
        return ops.boundary_mixed_sharded(stacked, x, mode_idx, mesh,
                                          dtype=dtype)
    return ops.boundary_mixed_op(stacked, x, mode_idx, dtype=dtype)


def mode_payload_bytes(cfg: ModelConfig, batch: int, seq: int,
                       mode: int) -> int:
    """Wire bytes for one boundary transfer in the given mode."""
    if mode == 0:
        return quant.payload_bytes((batch, seq, cfg.d_model), 0)
    w, bits = mode_widths(cfg.split)[mode - 1]
    return quant.payload_bytes((batch, seq, w), bits)


def compression_ratio(cfg: ModelConfig, mode: int) -> float:
    """Wire bytes of ``mode`` over mode 0's, for one token."""
    full = mode_payload_bytes(cfg, 1, 1, 0)
    return mode_payload_bytes(cfg, 1, 1, mode) / full
