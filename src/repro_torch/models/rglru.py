"""Griffin / RecurrentGemma recurrent block: a gated-linear-unit wrapper
around the RG-LRU (real-gated linear recurrent unit) with a short causal
depthwise conv [arXiv:2402.19427] (mirrors the serving parts of
``repro.models.rglru``).

The prefill's and the full-sequence pass's recurrence runs through
``ops.rglru_scan_op`` (the CUDA kernel on the card, the plain scan on the
CPU); their cell routes (``rglru_full(train=True)``,
``rglru_prefill(use_scan_op=False)``) step ``chunked_scan`` instead and
give the same bits. Decode is one recurrence step with the carried state.
The state ``{"h", "conv"}`` is updated in place (the reference returns a
new one). ``rglru_full(use_assoc_scan=True)`` is the reference's
log-depth scan in plain ops.

The reference promotes the model-dtype gate and conv weights to float32
against the f32 recurrence input on every call. ``rglru_prepare`` makes
those float32 forms (and the constant ``-softplus(-Λ)``) once per loaded
model; the serving engines run on prepared trees (``T.prepare_params``),
and an unprepared tree makes the same values on each call.

``group`` (a mesh's model group for this mixer) splits the channels:
``in_gate`` / ``in_rec`` by columns (the input's gradient summed over the
group, ``collectives.copy_to``), the conv, ``lam``, the gates' outputs,
the scan and the carry on the rank's channels, and ``out`` by rows (the
partial products summed over the group, ``layers.row_parallel_sum``). The
dense ``w_a`` / ``w_x`` [d_rnn, d_rnn] split by columns read the whole
conv output, gathered over the group (exact), so the arithmetic is one
device's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import collectives as CL
from repro_torch.models.layers import _normal, dense_init, row_parallel_sum
from repro_torch.models.scan_utils import chunked_scan

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


def _f32_forms(p):
    """The float32 forms the layer computes with every step: ``w_a`` /
    ``w_x`` weights and biases and the conv taps upcast (JAX promotes the
    model-dtype weights against the f32 input, so the products and the
    bias adds run in float32), and log sigmoid(Λ) = -softplus(-Λ)."""
    return {"w_a": {k: p["w_a"][k].float() for k in ("w", "b")},
            "w_x": {k: p["w_x"][k].float() for k in ("w", "b")},
            "conv": p["conv"].float(),
            "log_a": -F.softplus(-p["lam"])}


def rglru_prepare(p):
    """A layer's parameters with ``_f32_forms`` made once, under ``"f32"``:
    a new dict sharing the tensors of ``p``. A float32 model's forms alias
    its weights; a bf16 model's cost 2 d_rnn^2 + 7 d_rnn floats a layer
    (52.5 MB at d_rnn 2560). The values are those the unprepared path makes
    on each call, so the results are bit-identical."""
    return p if "f32" in p else {**p, "f32": _f32_forms(p)}


def _gates(f, u, group=None):
    """u: [..., d_rnn] f32 (this rank's channels over ``group``); ``f``:
    the layer's ``_f32_forms`` -> (a, gated input b), both f32, on the
    rank's channels. ``w_a`` / ``w_x`` take the whole u."""
    uf = CL.all_gather(u, group, -1)
    r = torch.sigmoid(uf @ f["w_a"]["w"] + f["w_a"]["b"])
    i = torch.sigmoid(uf @ f["w_x"]["w"] + f["w_x"]["b"])
    log_a = _C * r * f["log_a"]
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


def _cell_scan(a, b, h0):
    """The recurrence a step at a time through ``chunked_scan``: the
    product and the sum rounded separately, as the plain scan does."""
    def cell(carry, ab):
        at, bt = ab
        hh = at * carry + bt
        return hh, hh

    _, h = chunked_scan(cell, h0, (a.swapaxes(0, 1), b.swapaxes(0, 1)))
    return h.swapaxes(0, 1)


def _assoc_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1 in log2(S)
    doubling steps of the reference's ``combine`` (a_l a_r, a_r b_l + b_r):
    another summation tree than the step-by-step scan, so not its bits."""
    S, off = a.shape[1], 1
    while off < S:
        a_l, b_l = a[:, :-off], b[:, :-off]
        a_r, b_r = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_r * b_l + b_r], dim=1)
        a = torch.cat([a[:, :off], a_l * a_r], dim=1)
        off *= 2
    return b


def rglru_full(p, x, *, use_assoc_scan: bool = False, train: bool = False,
               group=None):
    """Full-sequence Griffin recurrent block from a zero state.
    x: [B, S, d] -> [B, S, d]. Default (eval) path: ``ops.rglru_scan_op``;
    ``train=True`` keeps the cell scan, as the reference does (the kernel
    has no backward); ``use_assoc_scan``: the log-depth scan of plain ops
    (``_assoc_scan``), eval or train. ``group``: the mixer's model group
    (see the module's docstring)."""
    from repro_torch.kernels import ops

    x = CL.copy_to(x, group)
    B, S, _ = x.shape
    f = p.get("f32") or _f32_forms(p)
    gate = _gate_branch(p, x)
    u = (x @ p["in_rec"]["w"]).float()
    pad = torch.cat([u.new_zeros((B, _CONV_W - 1, u.shape[2])), u], dim=1)
    u = sum(pad[:, i:i + S, :] * f["conv"][i] for i in range(_CONV_W))
    a, b = _gates(f, u, group)
    if use_assoc_scan:
        h = _assoc_scan(a, b)
    elif train:
        h = _cell_scan(a, b, a.new_zeros((B, a.shape[2])))
    else:
        h = ops.rglru_scan_op(a, b)
    return row_parallel_sum((h.to(x.dtype) * gate) @ p["out"]["w"], group)


def rglru_prefill(p, x, state, *, lengths=None, use_scan_op: bool = True,
                  group=None):
    """Full-sequence pass that leaves behind the decode state of each row.

    x: [B, S, d]; ``state``: the carry to continue (fresh zeros for a new
    prompt), updated in place. ``lengths``: optional [B] true lengths of a
    right-padded batch — pad steps are identity updates (a=1, b=0), so
    ``h[:, -1]`` is the carry after each row's own last real token.
    ``use_scan_op=False`` steps the cell scan instead of the scan op (the
    same bits). ``group``: the mixer's model group (``state`` then holds
    the rank's channels). Returns y [B, S, d]."""
    from repro_torch.kernels import ops

    B, S, _ = x.shape
    f = p.get("f32") or _f32_forms(p)
    gate = _gate_branch(p, x)
    u_pre = (x @ p["in_rec"]["w"]).float()                       # [B, S, dr]
    # continue the carried conv history (zeros for a fresh prompt)
    hist = torch.cat([state["conv"].float(), u_pre], dim=1)
    w = f["conv"]
    u_c = sum(hist[:, i:i + S, :] * w[i] for i in range(_CONV_W))
    a, b = _gates(f, u_c, group)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    lengths = lengths.to(device=x.device, dtype=torch.long)
    valid = (torch.arange(S, device=x.device)[None, :]
             < lengths[:, None])[..., None]
    a = torch.where(valid, a, 1.0)
    b = torch.where(valid, b, 0.0)
    h = (ops.rglru_scan_op(a, b, state["h"]) if use_scan_op
         else _cell_scan(a, b, state["h"]))
    y = row_parallel_sum((h.to(x.dtype) * gate) @ p["out"]["w"], group)
    # conv state after len steps = the last CONV_W-1 rows of
    # [carried history, u_0 .. u_{len-1}] = hist[len : len + CONV_W - 1]
    idx = lengths[:, None] + torch.arange(_CONV_W - 1, device=x.device)
    rows = torch.gather(hist, 1, idx[..., None].expand(-1, -1,
                                                      hist.shape[2]))
    state["h"].copy_(h[:, -1])
    state["conv"].copy_(rows.to(state["conv"].dtype))
    return y


def rglru_step(p, x, state, group=None):
    """One decode step. x: [B, 1, d]; ``state`` updated in place;
    ``group`` as in ``rglru_prefill``. Returns y [B, 1, d]."""
    f = p.get("f32") or _f32_forms(p)
    gate = _gate_branch(p, x)                                     # [B,1,dr]
    u = (x @ p["in_rec"]["w"]).float()                            # [B,1,dr]
    hist = torch.cat([state["conv"].float(), u], dim=1)
    u_c = torch.einsum("btd,td->bd", hist, f["conv"])[:, None, :]  # [B,1,dr]
    a, b = _gates(f, u_c, group)
    h = a[:, 0] * state["h"] + b[:, 0]                            # [B,dr]
    y = row_parallel_sum((h[:, None, :].to(x.dtype) * gate) @ p["out"]["w"],
                         group)
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:, :].to(state["conv"].dtype))
    return y
