"""Shared neural-network building blocks (PyTorch, functional style).

Mirrors ``repro.models.layers``: every module follows the
``init(generator, ...) -> params`` / ``apply(params, x)`` convention and
params are plain dicts of tensors, so the JAX reference's parameter trees
convert one-to-one (``repro_torch.convert``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale, dtype):
    return (scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=gen.device)).to(dtype)


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.bfloat16, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def embed_init(gen, vocab: int, d: int, *, dtype=torch.bfloat16):
    return {"table": _normal(gen, (vocab, d), 1.0, dtype)}


def embed_apply(p, ids):
    return p["table"][ids]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str = "rmsnorm", *, dtype=torch.bfloat16,
              device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """rmsnorm / layernorm over the last dim, computed in f32 and rounded
    back to ``x.dtype`` (the reference's op order)."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:  # layernorm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# gated MLP (llama-style)
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, *, dtype=torch.bfloat16):
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype=dtype),
        "w_up": dense_init(gen, d, d_ff, dtype=dtype),
        "w_down": dense_init(gen, d_ff, d, dtype=dtype),
    }


def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":                     # jax.nn.gelu defaults to tanh
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def mlp_apply(p, x, act: str = "silu"):
    g = _act(dense_apply(p["w_gate"], x), act)
    u = dense_apply(p["w_up"], x)
    return dense_apply(p["w_down"], g * u)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs          # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                   # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
