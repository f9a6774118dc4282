"""Time scans for the recurrent blocks (mirrors
``repro.models.scan_utils``).

``chunked_scan`` keeps the reference's signature: ``cell(state, x_t) ->
(state, y_t)`` over the leading time dimension of ``xs``, with the state,
the inputs and the outputs as trees (dicts, lists, tuples of tensors). It
is a loop over time, one eager step after another, so it computes
``lax.scan``'s values; the reference's per-chunk rematerialisation is a
training concern and belongs to the training slice (``chunk`` is accepted
and has no effect on the values).
"""
from __future__ import annotations

from typing import Callable

import torch


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


def chunked_scan(cell: Callable, state0, xs, *, chunk: int = 256):
    """scan(cell, state0, xs): returns (final state, outputs stacked along a
    new leading time dimension)."""
    del chunk
    T = _leaves(xs)[0].shape[0]
    state, ys = state0, []
    for t in range(T):
        state, y = cell(state, _map(lambda a: a[t], xs))
        ys.append(y)
    return state, _map(lambda *a: torch.stack(a), *ys)
