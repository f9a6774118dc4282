"""Expert-parallel MoE with an explicit all-to-all schedule (mirrors
``repro.models.moe_ep``) over a training mesh's model ranks.

Tokens shard as (batch over the dp axes) x (sequence over ``model``);
experts shard over ``model``. Per rank and per MoE layer:

    route its N_loc tokens -> build the send buffer [E, C, d] by index
    all_to_all over model      (dispatch: E * C * d elements)
    its experts' three products
    all_to_all back            (combine)
    gate-weighted rows summed back into token order

with the capacity C = max(int(cf * k * N_loc / E), 1) of the rank's block
(B/dp x S/m tokens): a capacity group is one rank's block, so at a tight
capacity the tokens that drop are those the block's own routing drops
(the one-device layer groups each batch row). Routing keeps the port's
conventions (``models.moe.route``): top-k ties go to the lowest expert,
slots are handed out token-major, then by choice.

The port's train step holds the residual replicated over model, so the
layer takes this rank's dp slice of the batch ``[B_loc, S, d]``, cuts its
own sequence block (the gradient of the whole input summed over the model
group, ``collectives.copy_to``), and gathers the blocks' outputs back
(``collectives.gather_replicated``). The router is replicated and each
rank routes other tokens, so its gradient is summed over the model group
too. The load-balance loss is averaged over the model group; the train
step averages it over the dp axes with the gradients (the reference
averages it over every axis in the layer).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import collectives as CL
from repro_torch.models.layers import _act
from repro_torch.models.moe import route


def _dp_size(mesh) -> int:
    return math.prod(v for a, v in mesh.shape.items() if a != "model")


def moe_supports_ep(n_experts: int, mesh, batch: int, seq: int) -> bool:
    """Tokens shard as batch over the dp axes x sequence over `model`
    (``batch``: the global batch size)."""
    if mesh is None or "model" not in mesh.shape:
        return False
    ep = mesh.shape["model"]
    return (n_experts % ep == 0 and batch % _dp_size(mesh) == 0
            and seq % ep == 0)


def _route_local(router_w, xg, k: int, capacity: int, n_experts: int):
    """Top-k routing with capacity of one rank's tokens xg [N, d] as one
    group. Returns (gates [N, k], expert [N, k], slot [N, k], keep [N, k],
    aux, a 0-d float32 tensor)."""
    probs, gates, idx, slot, keep = route(router_w, xg[None], k, capacity)
    frac_tokens = torch.mean(F.one_hot(idx[0], n_experts).amax(dim=1)
                             .float(), dim=0)
    frac_probs = torch.mean(probs[0], dim=0)
    aux = n_experts * torch.sum(frac_tokens * frac_probs)
    return gates[0], idx[0], slot[0], keep[0], aux


def moe_apply_ep(p, x, *, k: int, act: str = "silu",
                 capacity_factor: float = 1.25,
                 mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on a training mesh (``moe_supports_ep``): x [B_loc,
    S, d] is this rank's dp slice, replicated over model; ``p``'s experts
    are this rank's ``E / model`` (``sharding.shard_train_params``), its
    router whole. Returns (y [B_loc, S, d], aux)."""
    B, S, d = x.shape
    E = p["router"]["w"].shape[-1]
    group = mesh.group("model")
    ep = mesh.shape["model"]
    e_loc = E // ep
    if p["w_gate"].shape[0] != e_loc:
        raise ValueError(f"moe_apply_ep: {p['w_gate'].shape[0]} experts on "
                         f"this rank, the mesh splits {E} into {e_loc}")
    s_loc = S // ep
    lo = mesh.coords["model"] * s_loc
    n_loc = B * s_loc
    cap = max(int(capacity_factor * k * n_loc / E), 1)
    wdt = p["w_gate"].dtype

    xg = CL.copy_to(x, group)[:, lo:lo + s_loc].reshape(n_loc, d)
    router_w = CL.copy_to(p["router"]["w"], group)
    gates, idx, slot, keep, aux = _route_local(router_w, xg, k, cap, E)

    # the send buffer [E, cap, d] by index: each kept (token, choice)'s
    # row at its expert's slot, a zero row where no token lands
    dest = torch.where(keep, idx * cap + slot,
                       torch.full_like(slot, E * cap)).reshape(-1)
    tok = torch.arange(n_loc, device=x.device).repeat_interleave(k)
    src = torch.full((E * cap + 1,), n_loc, dtype=torch.long,
                     device=x.device)
    src.scatter_(0, dest, tok)
    rows = torch.cat([xg, xg.new_zeros(1, d)], dim=0)
    send = rows[src[:E * cap]].to(wdt).reshape(ep, e_loc, cap, d)

    recv = CL.all_to_all(send, group)       # [source rank, e_loc, cap, d]
    h = _act(torch.einsum("pecd,edf->pecf", recv, p["w_gate"]), act) * \
        torch.einsum("pecd,edf->pecf", recv, p["w_up"])
    out = torch.einsum("pecf,efd->pecd", h, p["w_down"])
    back = CL.all_to_all(out, group).reshape(E * cap, d)   # my tokens' rows

    at = torch.clamp(dest, max=E * cap - 1)
    w = torch.where(keep, gates, 0.0).to(wdt)
    vals = back[at].reshape(n_loc, k, d) * w[..., None]
    y = torch.sum(vals, dim=1).reshape(B, s_loc, d).to(x.dtype)
    return (CL.gather_replicated(y, group, dim=1),
            CL.pmean(aux, group))
