"""GShard-style mixture-of-experts layer (mirrors ``repro.models.moe``): a
top-k softmax router in float32, expert buffers of a fixed capacity per
routing group, and the Switch/GShard load-balance loss.

The reference fills its ``[G, E, C, d]`` expert buffers with ``[G, N, E,
C]`` one-hot einsums; this fills the same buffers by index (the
reference's own index form, ``repro.models.moe_ep``, at one expert
shard): each kept (token, choice) copies its row into its expert's slot,
the experts run as three batched products over ``[E, G * C, d]``, and the
combine adds each token's k gate-weighted rows in float32. The values are
the same: the dispatch einsum sums one ``1.0 * x`` and zeros a slot, the
combine one ``gate * out`` a choice. Only the experts' slots are computed.

Routing follows the reference exactly: top-k ties go to the lowest expert
index (as ``jax.lax.top_k``; a stable descending sort here), the capacity
is ``max(int(capacity_factor * k * N / E), 1)`` with Python's truncation,
and slots are handed out token-major, then by choice; a (token, choice)
past the capacity is dropped and adds zero.

Over a mesh's model ranks (``group``; the reference's ``_PARAM_RULES``
and ``_moe_alt_spec``), a rank holds ``E / m`` experts (where ``m``
divides E) or every expert's ``1 / m`` of the f axis. Every rank routes
every token with the replicated router; it dispatches only to its own
experts' slots (or computes its f part of every expert), and the ranks'
gate-weighted float32 rows are summed by one all_reduce before the cast
back. The tokens and the gates enter that part through
``collectives.copy_to``, so their gradients (and the router's) are the
one-device ones on every rank.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import collectives as CL
from repro_torch.models.layers import _act, _normal


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int, *,
             dtype=torch.bfloat16):
    """The router (float32 ``[d, E]``) and the experts' gated MLPs
    (``w_gate``, ``w_up`` ``[E, d, f]``, ``w_down`` ``[E, f, d]``), with the
    reference's scales."""
    return {
        "router": {"w": _normal(gen, (d, n_experts), d ** -0.5,
                                torch.float32)},
        "w_gate": _normal(gen, (n_experts, d, d_ff), d ** -0.5, dtype),
        "w_up": _normal(gen, (n_experts, d, d_ff), d ** -0.5, dtype),
        "w_down": _normal(gen, (n_experts, d_ff, d), d_ff ** -0.5, dtype),
    }


def route(router_w, xg, k: int, capacity: int):
    """Top-k routing of the groups' tokens xg ``[G, N, d]``. Returns
    (probs ``[G, N, E]`` float32, gates ``[G, N, k]`` renormalised over the
    k, expert ``[G, N, k]`` int64, slot ``[G, N, k]`` int64, keep ``[G, N,
    k]`` bool): each (token, choice)'s place in its expert's buffer,
    counted token-major, then by choice, and whether it is below
    ``capacity``."""
    G, N, _ = xg.shape
    E = router_w.shape[-1]
    probs = torch.softmax(xg.float() @ router_w.float(), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :k], idx[..., :k]
    gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    flat = F.one_hot(idx, E).reshape(G, N * k, E)
    before = torch.cumsum(flat, dim=1) - flat        # same expert, earlier
    slot = torch.gather(before, 2, idx.reshape(G, N * k, 1)).reshape(G, N, k)
    return probs, gates, idx, slot, slot < capacity


def moe_apply(p, x, *, k: int, act: str = "silu",
              capacity_factor: float = 1.25, group_size: int = 0,
              group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss, a 0-d float32 tensor).

    Tokens are routed within groups: one group a batch row, or
    ``group_size`` tokens when that divides S and is smaller. The
    dispatched rows take the experts' dtype, the experts' products run in
    it, and the combine is float32, cast back to ``x.dtype``. ``group``:
    the model ranks the experts (or their f axis) split over."""
    B, S, d = x.shape
    E = p["router"]["w"].shape[-1]
    e_loc = p["w_gate"].shape[0]
    e0 = CL.rank(group) * e_loc if e_loc < E else 0
    wdt = p["w_gate"].dtype
    if group_size and S % group_size == 0 and S > group_size:
        xg = x.reshape(B * (S // group_size), group_size, d)
    else:
        xg = x
    G, N, _ = xg.shape
    cap = max(int(capacity_factor * k * N / E), 1)
    probs, gates, expert, slot, keep = route(p["router"]["w"], xg, k, cap)
    if group is not None:
        xg, gates = CL.copy_to(xg, group), CL.copy_to(gates, group)
        keep = keep & (expert >= e0) & (expert < e0 + e_loc)

    # dispatch: the token of each (expert, slot) of this rank's experts, N
    # (a zero row) if none; dropped and other ranks' choices write the
    # spare column e_loc * cap
    spare = e_loc * cap
    dest = torch.where(keep, (expert - e0) * cap + slot,
                       torch.full_like(slot, spare)).reshape(G, N * k)
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    src = torch.full((G, spare + 1), N, dtype=torch.long, device=x.device)
    src.scatter_(1, dest, tok.expand(G, N * k))
    rows = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)
    xin = torch.gather(rows, 1, src[:, :spare, None].expand(-1, -1, d))
    xin = xin.to(wdt).reshape(G, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, G * cap, d)

    h = _act(torch.bmm(xin, p["w_gate"]), act) * torch.bmm(xin, p["w_up"])
    out = torch.bmm(h, p["w_down"])                     # [e_loc, G*cap, d]

    # combine: each kept choice's row, gate-weighted in float32
    out = out.reshape(e_loc, G, cap, d).transpose(0, 1).reshape(
        G, spare, d)
    at = torch.clamp(dest, max=spare - 1)
    vals = torch.gather(out, 1, at[..., None].expand(-1, -1, d)).float()
    vals = vals.reshape(G, N, k, d) * gates[..., None]
    y = torch.sum(torch.where(keep[..., None], vals, 0.0), dim=2)
    y = CL.reduce_from(y, group)

    # the Switch/GShard load-balance loss: the fraction of tokens choosing
    # each expert before drops (any of the k counts once) times its mean
    # router probability, summed over experts, E times its group mean
    frac_tokens = torch.mean(F.one_hot(expert, E).amax(dim=2).float(), dim=1)
    frac_probs = torch.mean(probs, dim=1)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return y.reshape(B, S, d).to(x.dtype), aux
