"""AdamW with freeze-mask support (mirrors ``repro.training.optimizer``: the
reference's own update math, not ``torch.optim``).

The freeze mask is how Algorithm 1's "Freeze(Encoder1, Decoder1)" is
implemented: masked leaves keep their value and their optimizer state is
never touched, so cascade phases share one optimizer and one step counter.

Parameter, gradient, moment and mask trees are nested dicts, lists and
tuples; their leaves are visited in the JAX package's order (dict keys
sorted), so the global norm sums the leaves in the reference's order. A
gradient leaf may be None (a leaf outside the loss's graph, as the phase-2
bottleneck is in mode 0): it counts as zeros. The schedule, the bias
corrections and the update are float32 tensor arithmetic on the
parameters' device, and nothing is read to the host.

On a training mesh a rank holds slices of some leaves (``split``: the
mesh axes each leaf is split over, ``sharding.split_axes``): the clip's
global norm sums those leaves' squares over their groups once, and counts
each replicated leaf once, so every rank clips by the one scale one
device would.
"""
from __future__ import annotations

import math
from typing import Any, Iterator, List, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import collectives as CL


class AdamState(NamedTuple):
    step: torch.Tensor          # 0-d int32, shared by every phase
    m: Any
    v: Any


def leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple in ``jax.tree.leaves``
    order (dict keys sorted); None and Python bools are leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, new: List[Any]):
    """``new`` (in ``leaves(like)`` order) nested as ``like`` is."""
    it = iter(new)
    out = _rebuild(like, it)
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def _rebuild(like, it: Iterator):
    if isinstance(like, dict):
        built = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: built[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device (a division by it is a
    true division on every device, where CUDA turns a division by a Python
    scalar into a multiply by its reciprocal)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def init(params) -> AdamState:
    ps = leaves(params)
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in ps]
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=ps[0].device),
        m=unflatten(params, zeros),
        v=unflatten(params, [torch.zeros_like(z) for z in zeros]))


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to 10% of the peak, at ``step`` (a
    0-d integer tensor); a 0-d float32 tensor."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    prog = torch.clamp(
        (s - _f32(cfg.warmup_steps, s))
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def _global_norm(gs, max_norm: float, split=None, group_of=None):
    """(the global norm of the gradient leaves ``gs``, the clip's scale
    factor). None leaves add nothing. ``split``: each leaf's mesh axes
    (None: replicated) in ``gs``'s order, and ``group_of(axes)`` their
    group: the squares of the leaves split over the same axes are summed
    over that group (one all_reduce a set of axes, in first-seen order),
    then added to the replicated leaves' sum."""
    split = split if split is not None else [None] * len(gs)
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g, a in zip(gs, split) if g is not None and a is None]
    parts: dict = {}
    for g, a in zip(gs, split):
        if g is not None and a is not None:
            parts.setdefault(a, []).append(
                torch.sum(torch.square(g.to(torch.float32))))
    for a, terms in parts.items():
        sq.append(CL.all_reduce_f32(sum(terms[1:], terms[0]), group_of(a)))
    gn = torch.sqrt(sum(sq[1:], sq[0]))
    return gn, torch.clamp(_f32(max_norm, gn) / torch.clamp(gn, min=1e-9),
                           max=1.0)


def clip_by_global_norm(grads, max_norm: float, split=None, group_of=None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before). None leaves stay None and add nothing to the norm. ``split``,
    ``group_of``: as in ``apply_updates``."""
    gs = leaves(grads)
    gn, scale = _global_norm(gs, max_norm, _split_leaves(split), group_of)
    return unflatten(grads, [None if g is None else g * scale.to(g.dtype)
                             for g in gs]), gn


# elements of a leaf the donated update takes at a time: its float32
# temporaries stay near 256 MB each, whatever the leaf's size
_DONATE_BLOCK = 1 << 26


def _row_blocks(p: torch.Tensor):
    """Index slices of ``p`` along its first dim, each of at most
    ``_DONATE_BLOCK`` elements where a row allows (the whole of a 0-d
    leaf)."""
    if p.dim() == 0:
        return [...]
    per = max(1, _DONATE_BLOCK // max(1, p[0].numel()))
    return [slice(i, i + per) for i in range(0, p.shape[0], per)]


def _split_leaves(split):
    """The leaves of a ``split`` tree in ``leaves`` order (axis tuples
    stay whole), or None without one."""
    def flat(node):
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in flat(node[k])]
        if isinstance(node, list) or (isinstance(node, tuple) and node
                                      and not isinstance(node[0], str)):
            return [x for v in node for x in flat(v)]
        return [node]
    return None if split is None else flat(split)


def apply_updates(params, grads, state: AdamState, cfg: TrainConfig,
                  mask=None, *, donate: bool = False, split=None,
                  group_of=None):
    """One AdamW step. ``mask``: the parameter tree with a bool at each
    leaf, True = trainable (None: all). The global norm takes every
    gradient, frozen leaves' too; a frozen leaf, its m and its v are
    returned as they were (the same tensors). ``split``: on a mesh, the
    parameter tree with each leaf's split axes (a tuple of axis names, or
    None: replicated), and ``group_of(axes)`` the group over those axes.

    ``donate=True`` (the reference launcher's ``donate_argnums``): each
    trainable leaf's new p, m and v are written into the tensors passed
    in, a block of rows at a time (``_row_blocks``), its clipped gradient
    made beside it, so the step holds one block's temporaries instead of a
    second set of parameters, moments and gradients. The trees passed in
    come back updated. Every op is elementwise and the arithmetic is that
    of ``donate=False``, so are the bits."""
    gs = leaves(grads)
    if donate:
        gnorm, scale = _global_norm(gs, cfg.grad_clip, _split_leaves(split),
                                    group_of)
    else:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, split,
                                           group_of)
        gs = leaves(grads)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf

    def upd(p, g, m, v):
        gf = torch.zeros_like(m) if g is None else g.to(torch.float32)
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        delta = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        delta = delta + lr * cfg.weight_decay * pf
        return (pf - delta).to(p.dtype), m_new, v_new

    ps, ms, vs = leaves(params), leaves(state.m), leaves(state.v)
    ts = leaves(mask) if mask is not None else [True] * len(ps)
    info = {"lr": lr, "grad_norm": gnorm}
    if donate:
        for p, g, m, v, trainable in zip(ps, gs, ms, vs, ts):
            if not trainable:
                continue
            for rows in _row_blocks(p):
                gr = None if g is None else g[rows] * scale.to(g.dtype)
                for old, new in zip((p[rows], m[rows], v[rows]),
                                    upd(p[rows], gr, m[rows], v[rows])):
                    old.copy_(new)
        return params, AdamState(step, state.m, state.v), info
    triples = [upd(p, g, m, v) if t else (p, m, v)
               for p, g, m, v, t in zip(ps, gs, ms, vs, ts)]
    p_new = unflatten(params, [t[0] for t in triples])
    m_new = unflatten(state.m, [t[1] for t in triples])
    v_new = unflatten(state.v, [t[2] for t in triples])
    return p_new, AdamState(step, m_new, v_new), info
