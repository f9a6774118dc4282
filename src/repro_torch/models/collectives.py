"""Differentiable collectives over a ``torch.distributed`` process group
(the port's counterparts of the ``jax.lax`` collectives the reference
calls inside ``shard_map``).

Each rank differentiates its own copy of the program, and the loss it
reaches is the same on every rank of a group (it is computed from
replicated values). The backward of each collective is its transpose
under that rule, so each rank gets the one-device gradient of a
replicated tensor and its own part of a split one:

- :func:`copy_to` (Megatron's "f", at a column-split input): identity;
  the backward sums the ranks' partial gradients (one all_reduce).
- :func:`reduce_from` ("g", after a row-split output): the sum of the
  ranks' partials in float32, rounded once; the backward is identity.
- :func:`all_gather` and :func:`reduce_scatter`, each the other's
  backward (the sequence-parallel pair: the gathered tensor feeds a
  rank's own products, whose partials are scattered back).
- :func:`gather_replicated`: an all_gather whose result is replicated
  (every rank reads the same whole tensor); the backward is this rank's
  slice of the gradient.
- :func:`all_to_all` and :func:`ppermute`, whose backwards are the
  reverse moves.
- :func:`psum` and :func:`pmean` of a 0-d tensor.

``group=None`` is a group of one rank: every collective is the identity.

How a move runs is chosen by the group's backend and the tensor's device
(``NATIVE``), never by trying one form and falling back: where the
backend takes the op on that device it runs natively, else it is built
from an ``all_reduce`` SUM of a zeroed buffer in an integer view, which
moves each rank's bits exactly (``-0.0`` and NaN payloads included), and
a scatter-sum is a float32 ``all_reduce`` and a slice. gloo takes only
``all_reduce`` and ``broadcast`` of CUDA tensors for certain, so ranks
sharing one card (gloo, since NCCL refuses two ranks on one device) take
the all_reduce forms.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: the moves a backend runs natively, by (backend, device type); the
#: others are built from an all_reduce
NATIVE = {
    ("nccl", "cuda"): frozenset({"all_gather", "reduce_scatter",
                                 "all_to_all", "ppermute"}),
    ("gloo", "cpu"): frozenset({"all_gather", "reduce_scatter",
                                "all_to_all", "ppermute"}),
    ("gloo", "cuda"): frozenset(),
    # the dry run's stand-in world (``launch/dryrun.py``): NCCL's forms,
    # which the production mesh runs, on shape-only tensors
    ("fake", "meta"): frozenset({"all_gather", "reduce_scatter",
                                 "all_to_all", "ppermute"}),
}
FORMS = ("native", "all_reduce")

_INTS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

#: this process's collective calls and the bytes of their buffers, by
#: the torch.distributed op issued, and its moves ("all_gather",
#: "reduce_scatter", "all_to_all", "ppermute") by name whatever their
#: form (``reset_counts`` zeroes)
COUNTS = {"calls": {}, "bytes": {}, "moves": {}}


def reset_counts() -> None:
    for v in COUNTS.values():
        v.clear()


def _moved(name: str) -> None:
    COUNTS["moves"][name] = COUNTS["moves"].get(name, 0) + 1


def _issue(op: str, t: torch.Tensor) -> None:
    COUNTS["calls"][op] = COUNTS["calls"].get(op, 0) + 1
    COUNTS["bytes"][op] = (COUNTS["bytes"].get(op, 0)
                           + t.numel() * t.element_size())


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def form_of(op: str, group, device: torch.device) -> str:
    """"native" where ``NATIVE`` lists ``op`` for the group's backend on
    ``device``, else "all_reduce". Raises ``ValueError`` for a backend and
    device the table does not know."""
    key = (dist.get_backend(group), torch.device(device).type)
    if key not in NATIVE:
        raise ValueError(f"no collective forms for backend {key[0]!r} on "
                         f"{key[1]} tensors")
    return "native" if op in NATIVE[key] else "all_reduce"


def _form(op: str, group, x: torch.Tensor, form: Optional[str]) -> str:
    if form is None:
        return form_of(op, group, x.device)
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    return form


# ---------------------------------------------------------------------------
# the raw moves (no autograd)
# ---------------------------------------------------------------------------

def all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 sum of ``x`` over ``group`` (a new tensor)."""
    acc = x.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    if group is not None:
        _issue("all_reduce", acc)
        dist.all_reduce(acc, group=group)
    return acc


def exact_sum(buf: torch.Tensor, group) -> torch.Tensor:
    """``buf`` summed over ``group`` in an integer view of its bits: exact
    where at most one rank writes each element and the others hold zeros
    (the all_reduce form of every move)."""
    n = buf.element_size()
    ints = _INTS[n]
    acc = buf.view(ints).to(torch.int64 if n == 8 else torch.int32)
    if group is not None:
        _issue("all_reduce", acc)
        dist.all_reduce(acc, group=group)
    return acc.to(ints).view(buf.dtype)


def gather_raw(x: torch.Tensor, group, dim: int = 0, *,
               form: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    m = size(group)
    if m == 1:
        return x
    dim = dim % x.dim()
    _moved("all_gather")
    if _form("all_gather", group, x, form) == "native":
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((m * xs.shape[0],) + xs.shape[1:])
        _issue("all_gather", out)
        dist.all_gather_into_tensor(out, xs, group=group)
        return out.movedim(0, dim)
    buf = x.new_zeros((m,) + x.shape)
    buf[rank(group)] = x
    return torch.cat(exact_sum(buf, group).unbind(0), dim=dim)


def scatter_sum_raw(x: torch.Tensor, group, dim: int = 0, *,
                    form: Optional[str] = None) -> torch.Tensor:
    """This rank's ``1/m`` slice along ``dim`` of the float32 sum of the
    ranks' ``x``."""
    m = size(group)
    x = x.float()
    if m == 1:
        return x
    dim = dim % x.dim()
    n = x.shape[dim] // m
    _moved("reduce_scatter")
    if _form("reduce_scatter", group, x, form) == "native":
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n,) + xs.shape[1:])
        _issue("reduce_scatter", xs)
        dist.reduce_scatter_tensor(out, xs, group=group)
        return out.movedim(0, dim)
    return all_reduce_f32(x, group).narrow(dim, rank(group) * n, n)


def all_to_all_raw(x: torch.Tensor, group, *,
                   form: Optional[str] = None) -> torch.Tensor:
    """``x`` [m, ...]: row j goes to rank j; returns [m, ...] whose row j
    came from rank j."""
    m = size(group)
    if m == 1:
        return x
    if x.shape[0] != m:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} != group "
                         f"size {m}")
    _moved("all_to_all")
    if _form("all_to_all", group, x, form) == "native":
        out = torch.empty_like(x.contiguous())
        _issue("all_to_all", out)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out
    buf = x.new_zeros((m,) + x.shape)             # [src, dst, ...]
    buf[rank(group)] = x
    return exact_sum(buf, group)[:, rank(group)].contiguous()


def ppermute_raw(x: torch.Tensor, group, perm: Sequence[Tuple[int, int]],
                 *, form: Optional[str] = None) -> torch.Tensor:
    """``x`` sent along the (source, destination) group ranks of ``perm``;
    a rank that receives nothing gets zeros."""
    m = size(group)
    if m == 1:
        return torch.zeros_like(x) if not any(
            s == d == 0 for s, d in perm) else x
    me = rank(group)
    _moved("ppermute")
    if _form("ppermute", group, x, form) == "native":
        out = torch.zeros_like(x)
        ops = []
        for s, d in perm:
            if s == me:
                ops.append((dist.isend, x.contiguous(),
                            dist.get_global_rank(group, d)))
            if d == me:
                ops.append((dist.irecv, out, dist.get_global_rank(group, s)))
        if ops:
            _issue("send_recv", x)
            if x.is_meta:      # no coalesced batch takes meta tensors
                reqs = [fn(t, peer, group=group) for fn, t, peer in ops]
            else:
                reqs = dist.batch_isend_irecv(
                    [dist.P2POp(fn, t, peer, group) for fn, t, peer in ops])
            for req in reqs:
                req.wait()
        return out
    buf = x.new_zeros((m,) + x.shape)             # [dst, ...]
    for s, d in perm:
        if s == me:
            buf[d] = x
    return exact_sum(buf, group)[me].clone()


# ---------------------------------------------------------------------------
# differentiable collectives
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_f32(g, ctx.group).to(g.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_f32(x, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum_raw(g, ctx.group, ctx.dim).to(g.dtype), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return gather_raw(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, rank(ctx.group) * ctx.n, ctx.n)
                .contiguous(), None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return scatter_sum_raw(x, group, dim).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return gather_raw(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(g, ctx.group), None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return ppermute_raw(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        rev = tuple((d, s) for s, d in ctx.perm)
        return ppermute_raw(g, ctx.group, rev), None, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = torch.full((), float(size(group)), dtype=torch.float32,
                           device=x.device)
        return (all_reduce_f32(x, group) / ctx.n).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return (g.float() / ctx.n).to(g.dtype), None


def copy_to(x, group):
    """Identity whose backward sums the gradient over ``group`` ("f")."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """The float32 sum over ``group``, rounded once to ``x``'s dtype, whose
    backward is identity ("g")."""
    return x if group is None else _ReduceFrom.apply(x, group)


def all_gather(x, group, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim``; backward:
    :func:`reduce_scatter`."""
    return x if group is None else _AllGather.apply(x, group, dim)


def gather_replicated(x, group, dim: int = 0):
    """The ranks' ``x`` concatenated along ``dim``, read alike by every
    rank; backward: this rank's slice."""
    return x if group is None else _GatherReplicated.apply(x, group, dim)


def reduce_scatter(x, group, dim: int = 0):
    """This rank's slice along ``dim`` of the float32 sum over ``group``,
    rounded once to ``x``'s dtype; backward: :func:`all_gather`."""
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def all_to_all(x, group):
    """``x`` [m, ...]: row j to rank j, row j of the result from rank j;
    backward: the reverse move."""
    return x if group is None else _AllToAll.apply(x, group)


def ppermute(x, group, perm):
    """``x`` along the (source, destination) group ranks of ``perm``
    (zeros where none arrives); backward: along the reverse pairs."""
    return _PPermute.apply(x, group, tuple(perm))


def psum(x, group):
    """The sum over ``group`` (a 0-d float32 tensor): :func:`reduce_from`."""
    return reduce_from(x, group)


def pmean(x, group):
    """The mean over ``group``; backward: the gradient over the group
    size (each rank's term weighs 1/m of the replicated mean)."""
    return x if group is None else _PMean.apply(x, group)


def mean_grads_(grads, group) -> None:
    """Average each gradient tensor of the list ``grads`` over ``group``
    in place (one float32 all_reduce a tensor; None entries are
    skipped)."""
    m = size(group)
    if m == 1:
        return
    for g in grads:
        if g is None:
            continue
        acc = all_reduce_f32(g, group)
        g.copy_(acc / torch.full((), float(m), dtype=torch.float32,
                                 device=acc.device))
