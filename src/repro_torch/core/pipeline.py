"""Two-stage pod pipeline: the paper's UE -> edge link mapped onto the
``pod`` axis of a training mesh (mirrors ``repro.core.pipeline``).

Each pod rank is a stage and holds its contiguous half of the layers
(``sharding.shard_train_params(stages=True)``). Stage 0 (the UE encoder)
runs its layers on each microbatch, pushes the boundary activation
through the selected bottleneck mode (mode 0 the
raw boundary; mode m the down-projection of head m, quantized to its
bits: the paper's layer A and wire format) and sends the payload to stage
1 (the edge decoder), which dequantizes it, applies the up adapter (layer
B) and finishes the stack. The reference's ``n_micro + n_stages - 1``
ticks run on every stage, as its scan does (a stage computes on zeros in
its bubble ticks), so every rank issues the same ops and collectives in
the same order, forward and backward. The last stage's output returns to
every pod by a float32 sum over the pod group, and the aux loss is
averaged over the stages.

Split learning across the link uses the straight-through estimator: the
forward wire carries int8 codes and row scales (or the raw boundary); the
backward wire carries the boundary's gradient, float, or int8 codes plus
row scales with ``bwd_bits=8``. The wire is one ``autograd.Function``
(quantize, send, dequantize; its backward the reverse link). Each rank
counts the payload bytes it sends each way in :data:`WIRE_BYTES`, the
counterpart of the reference test's parse of the compiled collectives.

Inside a stage, a mesh with ``model > 1`` runs the layers with the model
group's tensor-parallel plan (``plan``; ``cfg`` the rank's config), and a
mesh with ``data > 1`` holds its weights split over data (FSDP, as the
reference's GSPMD does inside a stage): each layer gathers them at each
tick, the LM head and the bank once a forward. The
embedding and the bottleneck head are replicated over the stages but used
by one of them, so their gradients are summed over the pod group
(``collectives.copy_to``), as are the batch's data ranks' by the train
step.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bottleneck, quant
from repro_torch.models import collectives as CL
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense_apply, norm_apply

#: payload bytes this process's wire sent: "fwd" (boundaries, stage to
#: stage) and "bwd" (their gradients back); ``reset_wire_bytes`` zeroes
WIRE_BYTES: Dict[str, int] = {"fwd": 0, "bwd": 0}


def reset_wire_bytes() -> None:
    WIRE_BYTES.update(fwd=0, bwd=0)


def stack_stages(params, cfg: ModelConfig, n_stages: int = 2):
    """The layer leaves as ``[n_stages, L / n_stages, ...]`` views (stage
    s holds layers ``s * L / n_stages`` on). Requires a homogeneous stack
    and ``L % n_stages == 0``."""
    if not cfg.homogeneous:
        raise ValueError("pod pipeline requires a homogeneous layer stack; "
                         "hybrid/ssm archs use the tensor-split path instead")
    L = cfg.n_layers
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    per = L // n_stages
    return T.tree_map(lambda a: a.reshape((n_stages, per) + a.shape[1:]),
                      params["layers"])


def _sent(perm, me: int, *tensors) -> int:
    """Bytes of ``tensors`` if this group rank sends in ``perm``."""
    if not any(s == me for s, _ in perm):
        return 0
    return sum(t.numel() * t.element_size() for t in tensors)


def _move(x, bits: int, group, perm, way: str):
    """``x`` over ``perm`` (quantized to ``bits`` first, dequantized to
    ``x``'s dtype after, where bits > 0), counted under ``way``."""
    me = CL.rank(group)
    if bits == 0:
        WIRE_BYTES[way] += _sent(perm, me, x)
        return CL.ppermute_raw(x, group, perm)
    codes, scales = quant.quantize(x, bits)
    WIRE_BYTES[way] += _sent(perm, me, codes, scales)
    codes = CL.ppermute_raw(codes, group, perm)
    scales = CL.ppermute_raw(scales, group, perm)
    return quant.dequantize(codes, scales, bits).to(x.dtype)


class _Wire(torch.autograd.Function):
    """Forward: quantize -> send (the uplink) -> dequantize. Backward: the
    boundary gradient over the reverse link, straight through the
    quantizer (quantized to ``bwd_bits`` where over 0)."""

    @staticmethod
    def forward(ctx, z, bits, perm, group, bwd_bits):
        ctx.perm, ctx.group, ctx.bwd_bits = perm, group, bwd_bits
        return _move(z, bits, group, perm, "fwd")

    @staticmethod
    def backward(ctx, g):
        rev = tuple((d, s) for s, d in ctx.perm)
        return (_move(g.contiguous(), ctx.bwd_bits, ctx.group, rev, "bwd"),
                None, None, None, None)


def _make_wire(bits: int, perm, group, bwd_bits: int = 0):
    """The wire of mode bits ``bits`` over ``perm`` (pairs of pod group
    ranks)."""
    perm = tuple(perm)
    return lambda z: _Wire.apply(z, bits, perm, group, bwd_bits)


def pipeline_apply(layers, bneck_head, x, positions, cfg: ModelConfig, *,
                   mesh, n_micro: int, mode: int, train: bool = False,
                   bwd_bits: int = 0, plan=None):
    """The layer stack as a two-stage pipeline over the ``pod`` axis.

    ``layers``: this stage's stacked ``[L / n_stages, ...]`` leaves
    (``sharding.shard_train_params(stages=True)``); x: the embedded
    inputs [B, S, d] of this rank's batch, B % n_micro == 0. Returns
    (hidden [B, S, d], aux)."""
    B, S, d = x.shape
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    n_stages = mesh.shape["pod"]
    stage = mesh.coords["pod"]
    group = mesh.group("pod")
    dtype = x.dtype
    per = cfg.n_layers // n_stages
    held = T.tree_leaves(layers)[0].shape[0]
    if held != per:
        raise ValueError(f"pipeline stage {stage} holds {held} layers, its "
                         f"share is {per} (shard_train_params(stages=True))")
    bits = 0 if mode == 0 else bottleneck.mode_widths(cfg.split)[mode - 1][1]
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    wire = _make_wire(bits, perm, group, bwd_bits)
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)

    x = CL.copy_to(x, group)
    head = (T.tree_map(lambda a: CL.copy_to(a, group), bneck_head)
            if mode >= 1 else None)
    mb = B // n_micro
    micro = x.reshape(n_micro, mb, S, d)
    posm = positions[:mb]

    def boundary_tx(h):
        """Sender-side bottleneck (layer A) and the wire."""
        if mode == 0:
            return wire(h)
        z = dense_apply(head["down"], norm_apply(head["norm"], h, "rmsnorm"))
        return wire(z)

    def boundary_rx(zq):
        """Receiver-side adapter (layer B)."""
        return zq if mode == 0 else dense_apply(head["up"], zq)

    recv = torch.zeros((mb, S, d), dtype=dtype, device=x.device)
    outs = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(n_micro + n_stages - 1):
        inp0 = micro[t] if t < n_micro else torch.zeros_like(micro[0])
        inp = torch.where(first, inp0, recv)
        h, a = T.run_layers(layers, inp, posm, cfg, train=train, plan=plan)
        recv = boundary_rx(boundary_tx(h))
        if t >= n_stages - 1:
            outs.append(h)
        aux = aux + a
    out = torch.where(last, torch.cat(outs, dim=0), 0.0)
    out = CL.reduce_from(out.float(), group).to(dtype)
    n = torch.full((), float(n_stages), dtype=torch.float32, device=x.device)
    return out, CL.psum(aux, group) / n


def pipeline_forward(params, tokens, cfg: ModelConfig, *, mesh,
                     n_micro: int = 4, mode: int = 0, train: bool = False,
                     bwd_bits: int = 0, embeddings=None, plan=None):
    """Embed -> pod pipeline -> unembed, on this rank's batch and
    parameters (its stage's layers). ``plan``: the
    model group's ``RankPlan`` inside a stage (``cfg`` the rank's config).
    Returns (logits, aux), the same on every pod rank."""
    params = sharding.fsdp_gather_top(params, plan)
    x = T.embed_tokens(params, tokens, cfg, embeddings)
    positions = T.seq_positions(x)
    modes = params.get("bneck_modes") or ()
    head = modes[mode - 1] if (mode >= 1 and modes) else None
    h, aux = pipeline_apply(params["layers"], head, x, positions, cfg,
                            mesh=mesh, n_micro=n_micro, mode=mode,
                            train=train, bwd_bits=bwd_bits, plan=plan)
    h = T.norm_apply_final(params, h, cfg)
    return T.lm_logits(params, h, cfg), aux
