"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory with recurrent gate connections) [arXiv:2405.04517] (mirrors
``repro.models.xlstm``).

Both are linear-time recurrences in the exact recurrent form with the
max-stabilizer m, which starts at -inf. The mLSTM's normalizer ``n`` runs
through ``ops.rglru_scan_op`` at prefill (the CUDA scan on the card, the
plain scan on the CPU); its matrix memory C and the sLSTM stay time loops
(``chunked_scan``). Decode is one step with the carried state, which is
updated in place (the reference returns a new one).

The port's two mLSTM routes (the scan op, and the fused cell) give the
same bits: the stabilised gates of a step come from one helper on the
same per-step slices in both, so the same operations run on the same
shapes, and each update rounds the products and the sum as the plain
scan does.

The sLSTM's input and recurrent weights meet f32 activations: JAX
promotes the model-dtype weights to f32 on every call. ``slstm_prepare``
makes those f32 forms once per loaded model (the engines run prepared
trees, ``T.prepare_params``); an unprepared tree makes the same values on
each call.

``group`` (a mesh's model group for these mixers; ``n_heads`` then the
rank's share) splits the heads. mLSTM: ``up_l`` / ``up_r`` by columns
(the input's gradient summed over the group, ``collectives.copy_to``),
``up_l``'s output gathered whole (exact) for ``wq`` / ``wk`` / ``wv`` /
``wi`` / ``wf``, which give the rank's heads; the normalizer scan and C
run on them, and ``down`` splits by rows (the partial products summed
over the group, ``layers.row_parallel_sum``). sLSTM: the
gate weights, biases and recurrent blocks and the carry on the rank's
channels (whole heads), the hidden state gathered whole for the up / gate
/ down path, which splits like an MLP, ``down`` by rows as the mLSTM's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import slstm_up_width
from repro_torch.models import collectives as CL
from repro_torch.models.layers import (_normal, dense_apply, dense_init,
                                       row_parallel_sum)
from repro_torch.models.scan_utils import chunked_scan

_MLSTM_PF = 2.0    # mLSTM up-projection factor
_GATES = ("i", "f", "z", "o")


def _log_sigmoid(x):
    """log sigmoid(x) = -softplus(-x), with softplus as ``jax.nn.softplus``
    computes it: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    y = -x
    return -(torch.clamp(y, min=0.0) + torch.log1p(torch.exp(-y.abs())))


def _stabilised_gates(m, log_f, i_pre):
    """One step's stabiliser and gates from the carried m: (m_new, i_g,
    f_g). A carried m of -inf (a fresh state) gives f_g = 0."""
    m_new = torch.maximum(log_f + m, i_pre)
    m_new = torch.where(torch.isfinite(m_new), m_new, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.where(torch.isfinite(m), torch.exp(log_f + m - m_new), 0.0)
    return m_new, i_g, f_g


def _keep_state(valid_b, new, old):
    """Per batch row, the updated state where ``valid_b`` else the carried
    one."""
    return {k: torch.where(valid_b.reshape((-1,) + (1,) * (v.dim() - 1)),
                           v, old[k]) for k, v in new.items()}


def _valid(lengths, B: int, S: int, device):
    if lengths is None:
        return torch.ones((B, S), dtype=torch.bool, device=device)
    lengths = torch.as_tensor(lengths, device=device).long()
    return torch.arange(S, device=device)[None, :] < lengths[:, None]


def _write(state, final):
    for k, v in final.items():
        state[k].copy_(v)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, d: int, n_heads: int, *, dtype=torch.bfloat16):
    di = int(_MLSTM_PF * d)
    return {
        "up_l": dense_init(gen, d, di, dtype=dtype),    # mlstm path
        "up_r": dense_init(gen, d, di, dtype=dtype),    # output gate path
        "wq": dense_init(gen, di, di, dtype=dtype),
        "wk": dense_init(gen, di, di, dtype=dtype),
        "wv": dense_init(gen, di, di, dtype=dtype),
        "wi": dense_init(gen, di, n_heads, bias=True, dtype=dtype),
        "wf": dense_init(gen, di, n_heads, bias=True, dtype=dtype),
        "down": dense_init(gen, di, d, dtype=dtype),
    }


def _mlstm_qkvif(p, x, n_heads, group=None):
    """x: [B,S,d] -> q,k,v [B,S,H,hd] fp32; i,f preacts [B,S,H] fp32 for
    the ``n_heads`` heads of this rank over ``group``."""
    xl = CL.all_gather(dense_apply(p["up_l"], x), group, -1)
    B, S, _ = xl.shape
    hd = p["wq"]["w"].shape[-1] // n_heads
    q = (xl @ p["wq"]["w"]).reshape(B, S, n_heads, hd).float()
    k = (xl @ p["wk"]["w"]).reshape(B, S, n_heads, hd).float()
    # a division by a device tensor: correctly rounded on the CPU and the
    # card (CUDA multiplies by the reciprocal of a Python scalar)
    k = k / torch.full((), math.sqrt(hd), dtype=torch.float32,
                       device=x.device)
    v = (xl @ p["wv"]["w"]).reshape(B, S, n_heads, hd).float()
    i_pre = dense_apply(p["wi"], xl).float()
    f_pre = dense_apply(p["wf"], xl).float()
    return xl, q, k, v, i_pre, f_pre


def mlstm_state_init(batch: int, d: int, n_heads: int, device=None,
                     shards: int = 1):
    """The zero state of ``n_heads`` heads of width ``2 d / n_heads``;
    ``shards``: one model rank's share of them (``n_heads / shards``)."""
    hd = int(_MLSTM_PF * d) // n_heads
    return _mlstm_zeros(batch, n_heads // shards, hd, device)


def _mlstm_zeros(batch: int, heads: int, hd: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, heads, hd, hd), **f32),
        "n": torch.zeros((batch, heads, hd), **f32),
        "m": torch.full((batch, heads), float("-inf"), **f32),
    }


def _mlstm_out(C, n, q):
    h_num = torch.einsum("bhij,bhj->bhi", C, q)
    h_den = torch.clamp(torch.einsum("bhj,bhj->bh", n, q).abs(), min=1.0)
    return h_num / h_den[..., None]


def _c_update(C, i_g, f_g, k, v):
    """f_g * C + i_g * (v ⊗ k), the reference's grouping."""
    return f_g[..., None, None] * C \
        + i_g[..., None, None] * (v[..., :, None] * k[..., None, :])


def _mlstm_cell(state, qkvif):
    q, k, v, i_pre, f_pre = qkvif          # per-timestep: [B,H,hd]x3, [B,H]x2
    m_new, i_g, f_g = _stabilised_gates(state["m"], _log_sigmoid(f_pre),
                                        i_pre)
    C = _c_update(state["C"], i_g, f_g, k, v)
    n = f_g[..., None] * state["n"] + i_g[..., None] * k
    return {"C": C, "n": n, "m": m_new}, _mlstm_out(C, n, q)


def _time_major(*xs):
    return tuple(x.swapaxes(0, 1) for x in xs)


def _mlstm_scan_op(q, k, v, i_pre, f_pre, state, valid):
    """Decomposed mLSTM recurrence routing the normalizer ``n`` — the one
    sub-recurrence of the exact ``h = a*h + b`` form — through
    ``ops.rglru_scan_op``. (1) The stabiliser m is a [B, H]-carry loop that
    also emits each step's gates; (2) the normalizer recurrence runs
    through the scan op with pad steps masked to identity (a=1, b=0) and
    ``state["n"]`` as h0; (3) only the [B, H, hd, hd] matrix memory C
    remains in ``chunked_scan``, with each step's candidate n recomputed
    from the op's carries. The per-step h is computed from candidate
    (pre-mask) state exactly like ``_mlstm_cell``, pad positions included.
    Returns (final_state, h [B, S, H, hd] f32)."""
    from repro_torch.kernels import ops

    B, S, H = i_pre.shape
    hd = k.shape[-1]

    def mstep(m, t):
        f_t, i_t, ok_t = t
        m_new, i_g, f_g = _stabilised_gates(m, _log_sigmoid(f_t), i_t)
        return torch.where(ok_t[:, None], m_new, m), (i_g, f_g)

    m_last, (i_g, f_g) = chunked_scan(mstep, state["m"],
                                      _time_major(f_pre, i_pre, valid))
    ok = valid.swapaxes(0, 1)[..., None, None]                # [S, B, 1, 1]
    kt = k.swapaxes(0, 1)
    a_n = torch.where(ok, f_g[..., None], 1.0).expand(S, B, H, hd)
    b_n = torch.where(ok, i_g[..., None] * kt, 0.0)
    n0 = state["n"].reshape(B, H * hd).contiguous()
    n_seq = ops.rglru_scan_op(
        a_n.swapaxes(0, 1).reshape(B, S, H * hd),
        b_n.swapaxes(0, 1).reshape(B, S, H * hd), n0).reshape(B, S, H, hd)
    n_prev = torch.cat([state["n"][:, None], n_seq[:, :-1]], dim=1)

    def cstep(C, t):
        k_t, v_t, q_t, ig_t, fg_t, np_t, ok_t = t
        C_new = _c_update(C, ig_t, fg_t, k_t, v_t)
        n_c = fg_t[..., None] * np_t + ig_t[..., None] * k_t
        h = _mlstm_out(C_new, n_c, q_t)
        return torch.where(ok_t.reshape(-1, 1, 1, 1), C_new, C), h

    C_last, hs = chunked_scan(
        cstep, state["C"],
        (kt, *_time_major(v, q), i_g, f_g, *_time_major(n_prev, valid)))
    final = {"C": C_last, "n": n_seq[:, -1], "m": m_last}
    return final, hs.swapaxes(0, 1)


def _mlstm_cell_scan(q, k, v, i_pre, f_pre, state, valid):
    """The fused-cell route: ``_mlstm_cell`` a step, pad steps keeping the
    carried state. Returns (final_state, h [B, S, H, hd] f32)."""
    def step(st, t):
        *qkvif, ok = t
        new, h = _mlstm_cell(st, qkvif)
        return _keep_state(ok, new, st), h

    final, hs = chunked_scan(step, state,
                             _time_major(q, k, v, i_pre, f_pre, valid),
                             chunk=64)
    return final, hs.swapaxes(0, 1)


def _mlstm_output(p, x, hs, group=None):
    B, S = x.shape[:2]
    h = hs.reshape(B, S, -1).to(x.dtype)
    gate = F.silu(dense_apply(p["up_r"], x))
    return row_parallel_sum(dense_apply(p["down"], h * gate), group)


def mlstm_full(p, x, n_heads: int, *, train: bool = False, group=None):
    """Full-sequence mLSTM block. x: [B,S,d] -> [B,S,d].

    Default (eval) path: the decomposed recurrence of ``_mlstm_scan_op``.
    ``train=True`` keeps the fused-cell scan, as the reference does (the
    scan kernel has no backward). ``group``: the mixer's model group
    (``n_heads`` the rank's)."""
    x = CL.copy_to(x, group)
    _, q, k, v, i_pre, f_pre = _mlstm_qkvif(p, x, n_heads, group)
    B, S = x.shape[:2]
    state = _mlstm_zeros(B, n_heads, q.shape[-1], x.device)
    route = _mlstm_cell_scan if train else _mlstm_scan_op
    _, hs = route(q, k, v, i_pre, f_pre, state, _valid(None, B, S, x.device))
    return _mlstm_output(p, x, hs, group)


def mlstm_prefill(p, x, state, n_heads: int, lengths=None, *,
                  use_scan_op: bool = True, group=None):
    """Full-sequence mLSTM that also leaves behind the final recurrent
    state (in ``state``, in place) — the batched replacement for looping
    ``mlstm_step``. ``lengths``: optional [B] true lengths for right-padded
    batches (pad steps keep the carried state). The normalizer runs
    through ``ops.rglru_scan_op``; ``use_scan_op=False`` keeps the
    fused-cell scan, which gives the same bits. ``group``: the mixer's
    model group (``n_heads`` and ``state`` the rank's). Returns y
    [B, S, d]."""
    _, q, k, v, i_pre, f_pre = _mlstm_qkvif(p, x, n_heads, group)
    B, S = x.shape[:2]
    route = _mlstm_scan_op if use_scan_op else _mlstm_cell_scan
    final, hs = route(q, k, v, i_pre, f_pre, state,
                      _valid(lengths, B, S, x.device))
    _write(state, final)
    return _mlstm_output(p, x, hs, group)


def mlstm_step(p, x, state, n_heads: int, group=None):
    """One decode step. x: [B,1,d]; ``state`` updated in place; ``group``
    as in ``mlstm_prefill``. Returns y [B,1,d]."""
    _, q, k, v, i_pre, f_pre = _mlstm_qkvif(p, x, n_heads, group)
    new, h = _mlstm_cell(
        state, (q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0]))
    _write(state, new)
    return _mlstm_output(p, x, h[:, None], group)


# ---------------------------------------------------------------------------
# sLSTM — stays on the fused-cell scan: h_{t-1} feeds every gate
# preactivation through the recurrent r_* matrices, so the recurrence is NOT
# of the h = a*h + b form the scan kernel computes.
# ---------------------------------------------------------------------------

def slstm_init(gen, d: int, n_heads: int, *, dtype=torch.bfloat16):
    hd = d // n_heads
    di = slstm_up_width(d)
    p = {"down": dense_init(gen, di, d, dtype=dtype),
         "up": dense_init(gen, d, di, dtype=dtype),
         "up_gate": dense_init(gen, d, di, dtype=dtype)}
    for g in _GATES:
        p[f"w_{g}"] = dense_init(gen, d, d, bias=True, dtype=dtype)
        # recurrent block-diagonal connection, stored per head [H, hd, hd]
        p[f"r_{g}"] = _normal(gen, (n_heads, hd, hd), hd ** -0.5, dtype)
    return p


def _slstm_f32_forms(p):
    """The float32 forms a step computes with: the gate weights and
    biases ``w_*`` and the recurrent ``r_*``, upcast (JAX promotes them
    against the f32 input and carry)."""
    f = {f"w_{g}": {k: p[f"w_{g}"][k].float() for k in ("w", "b")}
         for g in _GATES}
    f.update({f"r_{g}": p[f"r_{g}"].float() for g in _GATES})
    return f


def slstm_prepare(p):
    """A layer's parameters with ``_slstm_f32_forms`` made once, under
    ``"f32"``: a new dict sharing the tensors of ``p``. A float32 model's
    forms alias its weights; a bf16 model's cost 4 (d^2 + d + d^2 / H)
    floats a layer (12.4 MB at d 768, 4 heads). The values are those the
    unprepared path makes on each call, so the results are bit-identical."""
    return p if "f32" in p else {**p, "f32": _slstm_f32_forms(p)}


def slstm_state_init(batch: int, d: int, device=None):
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), float("-inf"), **f32),
            "h": torch.zeros((batch, d), **f32)}


def _slstm_cell(f, state, x_t, n_heads):
    """x_t: [B,d] f32 preact inputs; recurrent connections use h_{t-1};
    ``f``: the layer's ``_slstm_f32_forms``; the state holds the channels
    of ``n_heads`` heads."""
    B, d = state["h"].shape
    hd = d // n_heads
    h_prev = state["h"].reshape(B, n_heads, hd)

    def pre(g):
        wx = x_t @ f[f"w_{g}"]["w"] + f[f"w_{g}"]["b"]
        rh = torch.einsum("bhi,hij->bhj", h_prev, f[f"r_{g}"]).reshape(B, d)
        return wx + rh

    i_pre, f_pre, z_pre, o_pre = (pre(g) for g in _GATES)
    m_new, i_g, f_g = _stabilised_gates(state["m"], _log_sigmoid(f_pre),
                                        i_pre)
    c = f_g * state["c"] + i_g * torch.tanh(z_pre)
    n = f_g * state["n"] + i_g
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "m": m_new, "h": h}, h


def _slstm_output(p, x, hs, group=None):
    """hs: [B, S, d] f32 (the rank's channels over ``group``, gathered
    whole) -> the block's output in ``x.dtype``."""
    h = CL.all_gather(hs.to(x.dtype), group, -1)
    # jax.nn.gelu is the tanh approximation
    u = F.gelu(dense_apply(p["up"], h), approximate="tanh") \
        * dense_apply(p["up_gate"], h)
    return row_parallel_sum(dense_apply(p["down"], u), group)


def _slstm_scan(p, x, state, n_heads, valid):
    f = p.get("f32") or _slstm_f32_forms(p)

    def step(st, t):
        x_t, ok = t
        new, h = _slstm_cell(f, st, x_t, n_heads)
        return _keep_state(ok, new, st), h

    final, hs = chunked_scan(step, state, _time_major(x.float(), valid))
    return final, hs.swapaxes(0, 1)


def slstm_full(p, x, n_heads: int, group=None):
    """Full-sequence sLSTM block. x: [B,S,d] -> [B,S,d]. ``group``: the
    mixer's model group (``n_heads`` the rank's)."""
    x = CL.copy_to(x, group)
    B, S, _ = x.shape
    width = p["w_i"]["w"].shape[-1]              # the rank's channels
    _, hs = _slstm_scan(p, x, slstm_state_init(B, width, device=x.device),
                        n_heads, _valid(None, B, S, x.device))
    return _slstm_output(p, x, hs, group)


def slstm_prefill(p, x, state, n_heads: int, lengths=None, group=None):
    """Full-sequence sLSTM that leaves behind the final recurrent state (in
    ``state``, in place). ``lengths`` as in ``mlstm_prefill``; ``group``
    as in ``slstm_full`` (``state`` the rank's channels). Returns
    y [B, S, d]."""
    B, S, _ = x.shape
    final, hs = _slstm_scan(p, x, state, n_heads,
                            _valid(lengths, B, S, x.device))
    _write(state, final)
    return _slstm_output(p, x, hs, group)


def slstm_step(p, x, state, n_heads: int, group=None):
    """One decode step. x: [B,1,d]; ``state`` updated in place; ``group``
    as in ``slstm_prefill``. Returns y [B,1,d]."""
    f = p.get("f32") or _slstm_f32_forms(p)
    new, h = _slstm_cell(f, state, x[:, 0].float(), n_heads)
    _write(state, new)
    return _slstm_output(p, x, h[:, None], group)
