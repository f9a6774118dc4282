"""Time scans for the recurrent blocks (mirrors
``repro.models.scan_utils``), and the recomputation they and the layer
runners share.

``chunked_scan`` keeps the reference's signature: ``cell(state, x_t) ->
(state, y_t)`` over the leading time dimension of ``xs``, with the state,
the inputs and the outputs as trees (dicts, lists, tuples of tensors). It
is a loop over time, one eager step after another, so it computes
``lax.scan``'s values. While autograd records, a scan of more than
``chunk`` steps, a whole number of chunks, runs each chunk under ``remat``
(the reference's per-chunk ``jax.checkpoint``): the backward keeps one
recurrent state a chunk and recomputes the steps inside it. The values are
the same bits either way.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import checkpoint as _ckpt


def remat(fn: Callable, *args):
    """``fn(*args)`` whose activations are recomputed in the backward
    (``jax.checkpoint``'s counterpart; non-reentrant, so ``args`` may be
    trees and any of them may need no gradient). The same ops run in the
    same order on the same inputs, so values and gradients are the bits of
    the plain call."""
    return _ckpt.checkpoint(fn, *args, use_reentrant=False)


def recording(*trees) -> bool:
    """True when autograd records ops on the tensors of ``trees``."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(a) and a.requires_grad
        for t in trees for a in _leaves(t))


def _leaves(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _scan(cell: Callable, state, xs):
    T = _leaves(xs)[0].shape[0]
    ys = []
    for t in range(T):
        state, y = cell(state, _map(lambda a: a[t], xs))
        ys.append(y)
    return state, _map(lambda *a: torch.stack(a), *ys)


def chunked_scan(cell: Callable, state0, xs, *, chunk: int = 256):
    """scan(cell, state0, xs): returns (final state, outputs stacked along a
    new leading time dimension). Under autograd, each ``chunk``-step block
    of a scan of ``n * chunk`` steps (n > 1) is recomputed in the
    backward."""
    T = _leaves(xs)[0].shape[0]
    if T <= chunk or T % chunk != 0 or not recording(state0, xs):
        return _scan(cell, state0, xs)
    state, ys = state0, []
    for c in range(0, T, chunk):
        state, y = remat(_scan, cell, state,
                         _map(lambda a: a[c:c + chunk], xs))
        ys.append(y)
    return state, _map(lambda *a: torch.cat(a), *ys)
