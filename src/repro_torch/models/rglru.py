"""Griffin / RecurrentGemma recurrent block: a gated-linear-unit wrapper
around the RG-LRU (real-gated linear recurrent unit) with a short causal
depthwise conv [arXiv:2402.19427] (mirrors the serving parts of
``repro.models.rglru``).

The prefill's recurrence runs through ``ops.rglru_scan_op`` (the CUDA
kernel on the card, the plain scan on the CPU); decode is one recurrence
step with the carried state. The state ``{"h", "conv"}`` is updated in
place (the reference returns a new one). The training path
(``rglru_full``) is a later slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dense_init

_C = 8.0          # RG-LRU gate exponent constant
_CONV_W = 4       # temporal conv width


def rglru_init(gen, d: int, d_rnn: int, *, dtype=torch.bfloat16):
    dev = gen.device
    # Λ init so that a = sigmoid(Λ) ∈ (0.9, 0.999) as in the paper
    lin = torch.linspace(0.9, 0.999, d_rnn, dtype=torch.float32, device=dev)
    lam = torch.log(lin) - torch.log1p(-lin)
    return {
        "in_gate": dense_init(gen, d, d_rnn, dtype=dtype),   # GLU gate branch
        "in_rec": dense_init(gen, d, d_rnn, dtype=dtype),    # recurrence branch
        "conv": _normal(gen, (_CONV_W, d_rnn), _CONV_W ** -0.5, dtype),
        "w_a": dense_init(gen, d_rnn, d_rnn, bias=True, dtype=dtype),
        "w_x": dense_init(gen, d_rnn, d_rnn, bias=True, dtype=dtype),
        "lam": lam,
        "out": dense_init(gen, d_rnn, d, dtype=dtype),
    }


def _dense_f32(p, u):
    """``dense_apply`` on a float32 input: JAX promotes the model-dtype
    weights to float32, so the product and the bias add run in float32."""
    return u @ p["w"].float() + p["b"].float()


def _gates(p, u):
    """u: [..., d_rnn] f32 -> (a, gated input b), both f32."""
    r = torch.sigmoid(_dense_f32(p["w_a"], u))
    i = torch.sigmoid(_dense_f32(p["w_x"], u))
    # log sigmoid(Λ) = -softplus(-Λ)
    log_a = _C * r * (-F.softplus(-p["lam"]))
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u)
    return a, b


def _gate_branch(p, x):
    # jax.nn.gelu is the tanh approximation
    return F.gelu(x @ p["in_gate"]["w"], approximate="tanh")


def rglru_state_init(batch: int, d_rnn: int, dtype=torch.float32,
                     device=None):
    """The carry ``h`` in f32 and the conv history in the model dtype."""
    return {
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, d_rnn), dtype=dtype,
                            device=device),
    }


def rglru_prefill(p, x, state, *, lengths=None):
    """Full-sequence pass that leaves behind the decode state of each row.

    x: [B, S, d]; ``state``: the carry to continue (fresh zeros for a new
    prompt), updated in place. ``lengths``: optional [B] true lengths of a
    right-padded batch — pad steps are identity updates (a=1, b=0), so
    ``h[:, -1]`` is the carry after each row's own last real token.
    Returns y [B, S, d]."""
    from repro_torch.kernels import ops

    B, S, _ = x.shape
    gate = _gate_branch(p, x)
    u_pre = (x @ p["in_rec"]["w"]).float()                       # [B, S, dr]
    # continue the carried conv history (zeros for a fresh prompt)
    hist = torch.cat([state["conv"].float(), u_pre], dim=1)
    w = p["conv"].float()
    u_c = sum(hist[:, i:i + S, :] * w[i] for i in range(_CONV_W))
    a, b = _gates(p, u_c)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    lengths = lengths.to(device=x.device, dtype=torch.long)
    valid = (torch.arange(S, device=x.device)[None, :]
             < lengths[:, None])[..., None]
    a = torch.where(valid, a, 1.0)
    b = torch.where(valid, b, 0.0)
    h = ops.rglru_scan_op(a, b, state["h"])
    y = (h.to(x.dtype) * gate) @ p["out"]["w"]
    # conv state after len steps = the last CONV_W-1 rows of
    # [carried history, u_0 .. u_{len-1}] = hist[len : len + CONV_W - 1]
    idx = lengths[:, None] + torch.arange(_CONV_W - 1, device=x.device)
    rows = torch.gather(hist, 1, idx[..., None].expand(-1, -1,
                                                      hist.shape[2]))
    state["h"].copy_(h[:, -1])
    state["conv"].copy_(rows.to(state["conv"].dtype))
    return y


def rglru_step(p, x, state):
    """One decode step. x: [B, 1, d]; ``state`` updated in place. Returns
    y [B, 1, d]."""
    gate = _gate_branch(p, x)                                     # [B,1,dr]
    u = (x @ p["in_rec"]["w"]).float()                            # [B,1,dr]
    hist = torch.cat([state["conv"].float(), u], dim=1)
    w = p["conv"].float()
    u_c = torch.einsum("btd,td->bd", hist, w)[:, None, :]         # [B,1,dr]
    a, b = _gates(p, u_c)
    h = a[:, 0] * state["h"] + b[:, 0]                            # [B,dr]
    y = (h[:, None, :].to(x.dtype) * gate) @ p["out"]["w"]
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:, :].to(state["conv"].dtype))
    return y
