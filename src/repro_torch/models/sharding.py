"""The port's meshes over ranks of ``torch.distributed`` (mirrors
``repro.models.sharding``): the training half (the reference's parameter,
batch, activation and decode-state specs, its activation-rule context, and
:class:`TrainMesh`, the ``(pod?, data, model)`` ranks a train step runs
on) and the serving half (:class:`ServingMesh`, the ``(dp, mp)`` ranks of
an engine).

The reference drives every device of a mesh from one process under
``jit``. Here each rank is one process of a ``torch.distributed`` process
group, and a mesh object says what this rank does. A spec is a plain
tuple of axis names, of tuples of them, or ``None`` (the reference's
``PartitionSpec``), computed by the reference's rules from a mesh's
``shape`` (a dict of axis sizes: a mesh object, or any object with one).

Training (:class:`TrainMesh`): the ``model`` entries of a layer leaf's
spec split it over the model ranks (:func:`shard_train_params`), where its
block shards (:func:`check_model_parallel`, a predicate for each block
kind: attention where ``n_kv % model == 0``, a dense MLP where ``d_ff %
model == 0``, MoE experts where ``E % model == 0``, else each expert's f
axis where ``d_ff % model == 0``, an RG-LRU mixer where ``d_rnn % model ==
0``, the xLSTM mixers where ``n_heads % model == 0``; otherwise the block
runs replicated). The ``data`` entries split every leaf that has one over
the data ranks where its dimension divides (the reference's FSDP, ZeRO-3):
a layer gathers its weights over the data group just before use
(:func:`fsdp_gather`, inside the layer's recomputation), and the gradient
comes back as the reduce-scatter's sum. The embedding table has no data
entry; the final norm, the LM head and the bottleneck bank replicate over
model, as in serving. Three kinds of xLSTM leaves the reference
replicates split with their heads here (``_PORT_RULES``: the sLSTM's
recurrent ``r_*`` and the gate biases): a storage difference, the same
numbers. The
batch splits by :func:`batch_pspec`. The residual replicates over model
whatever ``act_policy`` says (the reference's ``seq`` policy shards it
under GSPMD; the quantized prefill, ``core/qtp.py``, runs the
sequence-parallel schedule itself).

Serving (:class:`ServingMesh`):

- **dp** shards the slot axis: slot ``s`` lives on dp shard ``s //
  (n_slots / dp)``; only that shard's ranks hold its pages (the paged
  pool) and write its state, and its tokens come from them. Where dp does
  not divide the slot axis, the axis replicates (every rank holds every
  slot), as the reference's ``_fit_spec`` drops the spec. A rank decodes
  every slot's row, in its place, as one device does: a GEMM's kernel,
  and with it its sums, is picked by the row count (cuBLAS on the card;
  on the CPU a float32 GEMM of one row takes another path), so rows
  decoded at another count part from one device's at a rounding edge (a
  qwen2.5-3b sync engine decoding 4 of 8 rows a rank did on the H100).
  The rows of slots a rank does not hold decode on scratch state
  (the paged pool's scratch page; the dense pool keeps every slot's row),
  and dp stays bit for bit the one-device engine.
- **mp** is Megatron tensor parallelism by the reference's ``_PARAM_RULES``:
  ``wq`` / ``wk`` / ``wv`` (and their biases) and ``w_gate`` / ``w_up``
  split by output columns, ``wo`` and ``w_down`` by input rows, each
  followed by one ``all_reduce`` over the mp group; the KV pool's head
  axis splits with them. MoE experts split over mp by the expert axis
  (``E % mp == 0``: each rank holds ``E / mp`` experts and routes every
  token with the replicated router) or else by each expert's f axis;
  their gate-weighted rows are summed by one float32 ``all_reduce``. An
  attention block shards only where ``n_kv % mp == 0`` and an MLP (or MoE
  layer) only where it divides; otherwise that block runs replicated on
  every rank. An RG-LRU mixer splits its channels (``in_gate`` /
  ``in_rec`` / ``w_a`` / ``w_x`` by columns, the conv, ``lam``, the scan
  and the carry by channel, ``out`` by rows; the dense ``w_a`` / ``w_x``
  read the whole conv output, one exact all_gather), the xLSTM mixers
  their heads (the mLSTM's ``up_l`` by columns, gathered whole for
  ``wq`` .. ``wf``, its C / n / m by head; the sLSTM's gates and carry by
  channel at head boundaries, its hidden state gathered whole for the
  up / gate / down path, split like an MLP); each ends in one
  ``all_reduce``. The embedding, the final norm, the LM
  head and the bottleneck bank stay replicated over mp (the reference
  shards the table and the head over ``model``), so the boundary and the
  fused decode tail stay single launches on whole rows.
- **The schedule** is the engine group leader's (its rank 0): every rank
  runs the same deterministic host bookkeeping, the leader broadcasts one
  fixed-size int64 control tensor at each decision point (:meth:`agree`)
  and that is what the device step runs; a rank whose own bookkeeping
  disagrees raises. Tokens reach every rank through one ``all_reduce``
  (SUM) of a zeroed int32 buffer into which each shard writes its own
  rows (:meth:`exchange`), exact for integers.
- **The scope** is the set of ranks that keep the engine's host state: the
  engine group itself, or every rank of an ``EdgeCluster`` (whose replicas
  live on disjoint groups and whose router runs on every rank).

Serving uses only ``all_reduce`` and ``broadcast``, which both NCCL and
gloo take on CUDA tensors; training's moves go through
``models.collectives``, which picks their form by backend and device.
``mesh=None`` everywhere is the one-device path, unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import re
import types
from typing import (Any, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, slstm_up_width
from repro_torch.models import collectives as CL

#: KV-cache leaf names (last path component), sharded over mp by head
KV_LEAVES = frozenset({"k", "v", "k_s", "v_s"})

#: block kinds a rank plan names, and the field of the plan each reads
BLOCK_GROUP = {"attn": "attn", "mlp": "mlp", "rglru": "rglru",
               "mlstm": "xlstm", "slstm": "xlstm"}


class RankPlan(NamedTuple):
    """What a rank's model calls need of the mesh: the model group of each
    block kind (None where that kind runs replicated), and on a training
    mesh with ``data > 1`` the data group its weights are gathered over
    with ``fsdp``, the data dim of each data-split leaf (``{"layers":
    {kind: {path in the layer: dim}}, "top": {path: dim}}``)."""
    attn: Any = None
    mlp: Any = None
    rglru: Any = None
    xlstm: Any = None
    data: Any = None
    fsdp: Any = None

    def group(self, kind: str):
        """The model group of a block kind ("attn", "mlp", "rglru",
        "mlstm", "slstm")."""
        return getattr(self, BLOCK_GROUP[kind])


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _new_group(ranks: Sequence[int]):
    """A process group of ``ranks`` (every rank of the world must call
    this, members or not): the world group itself when it is all of it
    (a world of one rank included, whose collectives then run), None for
    one rank of a larger world (nothing to reduce)."""
    ranks = list(ranks)
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    if len(ranks) == 1:
        return None
    return dist.new_group(ranks)


def _rank_device(rank: int, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", rank)


# ---------------------------------------------------------------------------
# which blocks shard over the model axis (both meshes)
# ---------------------------------------------------------------------------

def _kinds(cfg: ModelConfig) -> frozenset:
    return frozenset(cfg.block_kind(i) for i in range(cfg.n_layers))


def attn_sharded(cfg: ModelConfig, m: int) -> bool:
    """Attention splits its heads over ``m`` ranks where ``n_kv % m ==
    0``."""
    return m > 1 and "attn" in _kinds(cfg) and cfg.n_kv_heads % m == 0


def mlp_sharded(cfg: ModelConfig, m: int) -> bool:
    """A dense MLP splits where ``d_ff % m == 0``; a MoE layer where its
    experts (``E % m == 0``) or each expert's f axis divide."""
    if m == 1 or not cfg.d_ff:
        return False
    if cfg.is_moe and cfg.n_experts % m == 0:
        return True
    return cfg.d_ff % m == 0


def rglru_sharded(cfg: ModelConfig, m: int) -> bool:
    """An RG-LRU mixer splits its channels where ``d_rnn % m == 0``."""
    return m > 1 and "rglru" in _kinds(cfg) and (
        cfg.d_rnn or cfg.d_model) % m == 0


def xlstm_sharded(cfg: ModelConfig, m: int) -> bool:
    """The mLSTM and sLSTM mixers split their heads where ``n_heads % m ==
    0`` (and an sLSTM's up width divides too)."""
    kinds = _kinds(cfg)
    if m == 1 or not kinds & {"mlstm", "slstm"}:
        return False
    up = slstm_up_width(cfg.d_model) if "slstm" in kinds else 0
    return cfg.n_heads % m == 0 and up % m == 0


def check_model_parallel(cfg: ModelConfig, m: int) -> Dict[str, bool]:
    """Which block kinds split over ``m`` model ranks: {kind: bool} for
    "attn", "mlp", "rglru", "mlstm" and "slstm" (False: that block runs
    replicated, as the reference's ``_fit_spec`` drops a spec that does
    not divide). Raises ``ValueError`` for ``m < 1``."""
    if m < 1:
        raise ValueError(f"model axis must be >= 1, got {m}")
    xl = xlstm_sharded(cfg, m)
    return {"attn": attn_sharded(cfg, m), "mlp": mlp_sharded(cfg, m),
            "rglru": rglru_sharded(cfg, m), "mlstm": xl, "slstm": xl}


def _plan(cfg: ModelConfig, m: int, group) -> RankPlan:
    splits = check_model_parallel(cfg, m)
    return RankPlan(**{BLOCK_GROUP[k]: group for k, on in splits.items()
                       if on})


def local_cfg(cfg: ModelConfig, m: int) -> ModelConfig:
    """The rank's config at ``m`` model ranks: head counts where attention
    or the xLSTM mixers shard, ``d_rnn`` where the RG-LRU mixers do, and a
    dense MLP's ``d_ff`` (a MoE layer reads its sizes from its weights).
    ``dataclasses.replace`` keeps the full config's ``head_dim`` (a config
    built anew would derive it from the narrowed head count)."""
    kw: Dict[str, int] = {}
    if attn_sharded(cfg, m):
        kw.update(n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
                  head_dim=cfg.head_dim)
    if xlstm_sharded(cfg, m):
        kw.update(n_heads=cfg.n_heads // m, head_dim=cfg.head_dim)
    if rglru_sharded(cfg, m):
        kw["d_rnn"] = (cfg.d_rnn or cfg.d_model) // m
    if mlp_sharded(cfg, m) and not cfg.is_moe:
        kw["d_ff"] = cfg.d_ff // m
    return dataclasses.replace(cfg, **kw) if kw else cfg


class ServingMesh:
    """One engine's ``(dp, mp)`` ranks; built by :func:`serving_mesh` on
    every rank of the world (group creation is collective).

    ``ranks`` are the engine group's global ranks, dp-major: group rank
    ``i`` is ``(i // mp, i % mp)``. ``scope_ranks`` keep the engine's host
    state (default: the group). A rank outside the group is not a
    ``member``: it mirrors the host state and decodes nothing."""

    def __init__(self, dp: int, mp: int, ranks: Sequence[int],
                 scope_ranks: Sequence[int], device):
        self.dp, self.mp = int(dp), int(mp)
        self.ranks = tuple(int(r) for r in ranks)
        self.scope_ranks = tuple(int(r) for r in scope_ranks)
        self.rank = world()[0]
        self.leader = self.ranks[0]
        self.member = self.rank in self.ranks
        self.device = device
        self.backend = (dist.get_backend() if dist.is_initialized()
                        else None)
        i = self.ranks.index(self.rank) if self.member else -1
        self.coords = (i // self.mp, i % self.mp) if self.member else None
        grid = np.asarray(self.ranks).reshape(self.dp, self.mp)
        self.group = _new_group(self.ranks)
        self.scope = (self.group if self.scope_ranks == self.ranks
                      else _new_group(self.scope_ranks))
        # every rank creates every mp group, in the same order (tokens and
        # control go over the scope, so no collective runs over dp alone)
        self.mp_group = None
        for j in range(self.dp):
            g = _new_group(grid[j, :])
            if self.member and self.coords[0] == j:
                self.mp_group = g
        # host control rides the CPU under gloo, the device under NCCL
        self.ctl_device = (torch.device("cpu") if self.backend == "gloo"
                           else device)

    def __repr__(self) -> str:
        return (f"ServingMesh(dp={self.dp}, mp={self.mp}, "
                f"ranks={self.ranks}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")

    # -- slots over dp --------------------------------------------------------
    def slot_shards(self, n_slots: int) -> int:
        """dp shards of an ``n_slots`` axis: dp where it divides, else 1
        (replicated)."""
        return self.dp if n_slots % self.dp == 0 else 1

    def shard_of(self, slot: int, n_slots: int) -> int:
        return int(slot) // (n_slots // self.slot_shards(n_slots))

    def slot_rows(self, n_slots: int) -> Tuple[int, int]:
        """[lo, hi) of the slots this rank holds; (0, 0) off the group."""
        if not self.member:
            return 0, 0
        shards = self.slot_shards(n_slots)
        if shards == 1:
            return 0, n_slots
        per = n_slots // shards
        return self.coords[0] * per, (self.coords[0] + 1) * per

    def writes_tokens(self, n_slots: int) -> bool:
        """This rank's rows go into the token exchange: mp rank 0 of each
        dp shard (dp rank 0 where the slot axis replicates)."""
        if not self.member or self.coords[1] != 0:
            return False
        return self.slot_shards(n_slots) > 1 or self.coords[0] == 0

    # -- weights over mp ------------------------------------------------------
    def check_model(self, cfg: ModelConfig) -> Dict[str, bool]:
        """Which block kinds split over mp (``check_model_parallel``)."""
        return check_model_parallel(cfg, self.mp)

    def rank_plan(self, cfg: ModelConfig) -> Optional[RankPlan]:
        """The ``RankPlan`` of ``T.run_layers_*`` on this rank, or None at
        mp 1."""
        if not self.member or self.mp == 1:
            return None
        return _plan(cfg, self.mp, self.mp_group)

    def local_cfg(self, cfg: ModelConfig) -> ModelConfig:
        return local_cfg(cfg, self.mp)

    # -- collectives ----------------------------------------------------------
    def agree(self, values, what: str, src: Optional[int] = None
              ) -> np.ndarray:
        """The deciding rank's int64 control vector (``values``, of the
        same fixed size on every rank of the scope; ``src`` default the
        leader): one broadcast. A rank whose own ``values`` differ raises:
        its host bookkeeping diverged."""
        src = self.leader if src is None else src
        mine = np.asarray(values, np.int64)
        t = torch.as_tensor(mine).to(self.ctl_device)
        if self.scope is not None:
            dist.broadcast(t, src, group=self.scope)
        theirs = t.cpu().numpy()
        if not np.array_equal(mine, theirs):
            raise RuntimeError(
                f"rank {self.rank}: {what} differs from rank {src}'s: "
                f"{mine.tolist()} != {theirs.tolist()}")
        return theirs

    def share(self, t: torch.Tensor) -> torch.Tensor:
        """The leader's copy of ``t`` (same shape and dtype on every rank
        of the scope), in place: one broadcast."""
        if self.scope is not None:
            dist.broadcast(t, self.leader, group=self.scope)
        return t

    def exchange(self, local: torch.Tensor, n_slots: int,
                 axis: int = 1) -> torch.Tensor:
        """Every slot's int32 tokens from each shard's rows: ``local`` holds
        this rank's rows ``slot_rows`` along ``axis``; returns the whole
        slot axis on every rank of the scope (one all_reduce SUM of a
        zeroed buffer, exact for integers)."""
        shape = list(local.shape)
        shape[axis] = n_slots
        buf = torch.zeros(shape, dtype=torch.int32, device=self.device)
        if self.writes_tokens(n_slots):
            lo, hi = self.slot_rows(n_slots)
            buf.narrow(axis, lo, hi - lo).copy_(local)
        if self.scope is not None:
            dist.all_reduce(buf, group=self.scope)
        return buf

    def gather_exact(self, full: torch.Tensor) -> torch.Tensor:
        """``full`` (zeros except where this rank writes its part) summed
        over the scope as integers, so every rank gets the writers' bits
        exactly (a float sum would turn -0.0 into +0.0)."""
        n = full.element_size()
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[n]
        acc = full.view(ints).to(torch.int64 if n == 8 else torch.int32)
        if self.scope is not None:
            dist.all_reduce(acc, group=self.scope)
        return acc.to(ints).view(full.dtype)


def serving_mesh(dp: int, mp: int = 1, *, ranks: Optional[Sequence[int]]
                 = None, device=None,
                 scope_ranks: Optional[Sequence[int]] = None) -> ServingMesh:
    """The serving ``(dp, mp)`` mesh over global ranks ``ranks`` (default
    the first ``dp * mp``) of the initialized default process group; call
    it on every rank of the world. Rank r runs on ``cuda:r`` unless
    ``device`` (one device for this rank, e.g. ``"cpu"`` or ``"cuda:0"``)
    is given. ``scope_ranks``: the ranks that keep the engine's host state
    (default ``ranks``). Raises ``ValueError`` for an axis under 1 or too
    few ranks."""
    if dp < 1 or mp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp} mp={mp}")
    need = dp * mp
    rank, size = world()
    if ranks is None:
        ranks = range(need)
    ranks = list(ranks)
    if need > size or len(ranks) != need or max(ranks) >= size:
        raise ValueError(
            f"mesh ({dp} x {mp}) needs {need} ranks, only {size} available: "
            f"run one process a rank (torchrun --nproc-per-node {need}, or "
            f"the launchers' own --dp/--mp, which start them) and "
            f"initialize torch.distributed before building the mesh")
    return ServingMesh(dp, mp, ranks,
                       ranks if scope_ranks is None else list(scope_ranks),
                       _rank_device(rank, device))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _path_leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _path_leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _path_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _map_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, f"{prefix}/{i}" if prefix
                                     else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def shard_params(params, mesh: Optional[ServingMesh], *, cfg: ModelConfig):
    """The rank's parameter tree: each split leaf's slice (a contiguous
    copy: the columns or rows of this mp rank's heads, channels or ``d_ff``
    part, or its experts), every replicated tensor shared with ``params``.
    Stacked ``[L, ...]`` leaves keep their leading axis. No-op without a
    mesh or at mp 1."""
    if mesh is None or mesh.mp == 1:
        return params
    return _local_slices(params, cfg, (("model", mesh.mp),),
                         {"model": mesh.coords[1]})


def _state_axis(path: str, cfg: ModelConfig, m: int) -> Optional[int]:
    """The axis (from the end) along which a decode-state leaf splits over
    ``m`` model ranks, or None: the KV heads where attention shards, an
    RG-LRU carry's channels (``h`` [B, d_rnn], ``conv`` [B, 3, d_rnn]),
    an mLSTM's heads (``C`` [B, H, hd, hd], ``n`` [B, H, hd], ``m`` [B,
    H]) and an sLSTM's channels (``c`` / ``n`` / ``m`` / ``h`` [B, d])
    where those mixers shard."""
    parts = path.split("/")
    leaf = parts[-1]
    if leaf in KV_LEAVES:
        return -2 if attn_sharded(cfg, m) else None
    if cfg.homogeneous or not parts[0].isdigit():
        return None
    kind = cfg.block_kind(int(parts[0]))
    if kind == "rglru" and rglru_sharded(cfg, m):
        return -1
    if kind == "slstm" and xlstm_sharded(cfg, m):
        return -1
    if kind == "mlstm" and xlstm_sharded(cfg, m):
        return {"C": -3, "n": -2, "m": -1}[leaf]
    return None


def shard_state(states, mesh: Optional[ServingMesh], cfg: ModelConfig):
    """This mp rank's slice (a view) of every split leaf of a whole decode
    state (the layout ``T.init_decode_state`` makes at mp 1): the KV heads
    and the recurrent carries' channels or heads (``_state_axis``); other
    leaves as they are."""
    if mesh is None or mesh.mp == 1 or not mesh.member:
        return states
    m, i = mesh.mp, mesh.coords[1]

    def one(path, a):
        axis = _state_axis(path, cfg, m)
        if axis is None:
            return a
        n = a.shape[axis] // m
        return a.narrow(a.dim() + axis, i * n, n)

    return _map_paths(one, states)


def unshard_state(local, mesh: ServingMesh, cfg: ModelConfig, full_like,
                  holds: bool):
    """The whole state on every rank of the scope from its holders'
    parts. ``holds``: this rank writes its part (``local``, ignored
    otherwise): one holder of each slot's shard, every mp rank of it for
    the split leaves (``_state_axis``), mp rank 0 for the rest.
    ``full_like``: a tree of the whole shapes and dtypes (e.g. on the meta
    device). Exact: each leaf is an integer sum of zero-padded parts."""
    m = mesh.mp
    mp_idx = mesh.coords[1] if mesh.member else 0
    parts = dict(_path_leaves(local)) if holds else {}

    def one(path, meta):
        axis = _state_axis(path, cfg, m) if m > 1 else None
        buf = torch.zeros(meta.shape, dtype=meta.dtype, device=mesh.device)
        if holds and (axis is not None or mp_idx == 0):
            if axis is not None:
                n = meta.shape[axis] // m
                dst = buf.narrow(buf.dim() + axis, mp_idx * n, n)
            else:
                dst = buf
            dst.copy_(parts[path])
        return mesh.gather_exact(buf)

    return _map_paths(one, full_like)


# ---------------------------------------------------------------------------
# training: the activation-rule context
# ---------------------------------------------------------------------------

_ACTIVATION_CTX: Dict[str, Any] = {"mesh": None, "rules": {}}


@contextlib.contextmanager
def activation_rules(mesh, rules: Dict[str, Any]):
    """Install ``rules`` (``default_activation_rules``) and ``mesh`` for
    the model code under the block (``ctx_mesh``, ``ctx_flag``)."""
    old = dict(_ACTIVATION_CTX)
    _ACTIVATION_CTX.update(mesh=mesh, rules=rules)
    try:
        yield
    finally:
        _ACTIVATION_CTX.update(old)


def ctx_mesh():
    """Mesh of the installed activation rules (None outside a mesh ctx)."""
    return _ACTIVATION_CTX["mesh"]


def ctx_flag(name: str) -> bool:
    """Boolean flags riding the activation-rule context (``moe_ep``
    switches the MoE layer to the expert-parallel schedule)."""
    return bool(_ACTIVATION_CTX["rules"].get(name, False))


def ctx_rule(name: str, default=None):
    """Entry ``name`` of the installed rules (the port's train step adds
    ``"batch"``, the global batch size, which a rank's slice no longer
    shows), else ``default``."""
    return _ACTIVATION_CTX["rules"].get(name, default)


# ---------------------------------------------------------------------------
# training: divisibility-aware spec fitting
# ---------------------------------------------------------------------------

def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _fit_spec(spec, shape, mesh) -> tuple:
    """Drop sharding on dims the mesh axes don't divide (or that don't
    exist); pad the spec with None up to the rank. Tuple axes degrade by
    trimming trailing axes."""
    out = []
    for i, dim in enumerate(shape):
        axis = spec[i] if i < len(spec) else None
        if isinstance(axis, (tuple, list)):
            axis = tuple(axis)
            while axis and dim % _axis_size(mesh, axis) != 0:
                axis = axis[:-1]
            axis = axis or None
        elif axis is not None and dim % _axis_size(mesh, axis) != 0:
            axis = None
        out.append(axis)
    return tuple(out)


# (regex on the '/'-joined tree path, spec WITHOUT the stacked-layer dim)
_PARAM_RULES = [
    # embeddings / heads
    (r"embed/table$", {2: ("model", None), 3: (None, "model", None)}),
    (r"lm_head/w$", {2: ("data", "model"), 3: (None, "data", "model")}),
    # attention
    (r"mix/wq/w$", ("data", "model")),
    (r"mix/wk/w$", ("data", "model")),
    (r"mix/wv/w$", ("data", "model")),
    (r"mix/wo/w$", ("model", "data")),
    (r"mix/w[qkv]/b$", ("model",)),
    # dense MLP
    (r"mlp/w_gate/w$", ("data", "model")),
    (r"mlp/w_up/w$", ("data", "model")),
    (r"mlp/w_down/w$", ("model", "data")),
    # MoE: the expert dim over model when divisible, else the d/f dims
    (r"mlp/router/w$", (None, None)),
    (r"mlp/w_gate$", ("model", "data", None)),
    (r"mlp/w_up$", ("model", "data", None)),
    (r"mlp/w_down$", ("model", None, "data")),
    # RG-LRU
    (r"mix/in_gate/w$", ("data", "model")),
    (r"mix/in_rec/w$", ("data", "model")),
    (r"mix/w_[ax]/w$", ("data", "model")),
    (r"mix/w_[ax]/b$", ("model",)),
    (r"mix/conv$", (None, "model")),
    (r"mix/lam$", ("model",)),
    (r"mix/out/w$", ("model", "data")),
    # xLSTM
    (r"mix/up_[lr]/w$", ("data", "model")),
    (r"mix/up/w$", ("data", "model")),
    (r"mix/up_gate/w$", ("data", "model")),
    (r"mix/w[qkvifzo]/w$", ("data", "model")),
    (r"mix/w_[ifzo]/w$", ("data", "model")),
    (r"mix/down/w$", ("model", "data")),
    (r"mix/r_[ifzo]$", (None, None, None)),
    # bottleneck heads (core/bottleneck.py)
    (r"down/w$", ("data", "model")),
    (r"up/w$", ("model", "data")),
]

#: leaves the reference replicates and the port splits with their heads
#: over model (a storage difference: each rank uses only its heads' part),
#: consulted before ``_PARAM_RULES`` by the port's own layout
_PORT_RULES = [
    (r"mix/w[if]/b$", ("model",)),           # mLSTM gate biases, a head each
    (r"mix/w_[ifzo]/b$", ("model",)),        # sLSTM gate biases, by channel
    (r"mix/r_[ifzo]$", ("model", None, None)),   # sLSTM recurrence, by head
]


def _moe_alt_spec(name: str, shape, mesh) -> Optional[tuple]:
    """MoE expert weights when E doesn't divide ``model``: shard d/f
    dims."""
    E = shape[-3] if len(shape) >= 3 else 0
    if E and E % _axis_size(mesh, "model") != 0:
        if name.endswith("w_down"):
            return (*([None] * (len(shape) - 3)), None, "model", "data")
        return (*([None] * (len(shape) - 3)), None, "data", "model")
    return None


def param_pspecs(params, mesh, *, stacked_layers: bool = True,
                 tp_scope: str = "all"):
    """The tree of specs matching ``params`` (the reference's rules).

    ``stacked_layers``: leaves under 'layers/' carry a leading L dim that
    stays unsharded. ``tp_scope``: 'all' (megatron TP everywhere) or 'ffn'
    (attention / mixer weights replicated over ``model``)."""
    def rule_for(name, leaf):
        in_layers = name.startswith("layers/")
        stacked = stacked_layers and in_layers and not re.match(
            r"layers/\d", name)
        shape = tuple(leaf.shape)
        base_rank = len(shape) - (1 if stacked else 0)
        for pat, spec in _PARAM_RULES:
            if re.search(pat, name):
                if isinstance(spec, dict):
                    spec = spec.get(base_rank, ())
                if "mlp/w_" in name and not name.endswith("/w"):
                    alt = _moe_alt_spec(name, shape, mesh)
                    if alt is not None:
                        spec = tuple(alt[-base_rank:])
                if tp_scope == "ffn" and "mix/" in name:
                    spec = tuple(None if a == "model" else a for a in spec)
                if stacked:
                    spec = (None, *spec)
                return _fit_spec(spec, shape, mesh)
        return ()  # replicate (norms, small params, LSTM PoC)

    return _map_paths(rule_for, params)


# ---------------------------------------------------------------------------
# training: activation / batch / decode-state rules
# ---------------------------------------------------------------------------

def dp_axes(mesh) -> tuple:
    """Mesh axes used for data parallelism (pod folds into data if
    present)."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def all_axes(mesh) -> tuple:
    """Every mesh axis, for fully-data-parallel activations."""
    return tuple(mesh.shape.keys())


def batch_pspec(mesh, rank: int, batch_size: int,
                act_policy: str = "seq") -> tuple:
    """The batch's spec: batch over the dp axes (``batch2d``: every axis),
    trailing axes dropped until the batch divides, else replicated."""
    dp = all_axes(mesh) if act_policy == "batch2d" else dp_axes(mesh)
    while dp and batch_size % _axis_size(mesh, dp) != 0:
        dp = dp[:-1] or None
    return (dp, *([None] * (rank - 1)))


def default_activation_rules(mesh, *, seq_shard: bool = True,
                             act_policy: Optional[str] = None,
                             moe_ep: bool = False) -> Dict[str, Any]:
    """Residual stream and logits specs of the reference's policies
    (``seq``: batch over dp and sequence over ``model``; ``batch``: batch
    over dp; ``batch2d``: batch over every axis), and the ``moe_ep`` flag.
    ``seq_shard=False`` means ``batch``. The port's train step reads only
    the flag: its residual replicates over model under every policy."""
    policy = act_policy or ("seq" if seq_shard else "batch")
    dp = dp_axes(mesh)
    rules: Dict[str, Any] = {"logits": (dp, None, "model")}
    if policy == "seq":
        rules["resid"] = (dp, "model", None)
    elif policy == "batch":
        rules["resid"] = (dp, None, None)
    elif policy == "batch2d":
        axes = all_axes(mesh)
        rules["resid"] = (axes, None, None)
        rules["logits"] = (axes, None, None)
    else:
        raise ValueError(f"unknown act_policy {policy!r}")
    if moe_ep:
        rules["moe_ep"] = True
    return rules


def state_pspecs(states, mesh, batch: int, *, stacked: bool):
    """Decode-state (KV cache / recurrent state) specs: batch over data;
    KV heads over model when divisible, else the cache's time dim."""
    dp = dp_axes(mesh)
    bdp = dp if batch % _axis_size(mesh, dp) == 0 else None

    def rule(name, leaf):
        shape = tuple(leaf.shape)
        off = 1 if stacked else 0           # leading L dim
        spec: list = [None] * len(shape)
        if len(shape) - off >= 1:
            spec[off] = bdp                 # batch dim
        if name.endswith(("k", "v", "k_s", "v_s")) and len(shape) - off == 4:
            n_kv, T = shape[off + 2], shape[off + 1]
            m = _axis_size(mesh, "model")
            if n_kv % m == 0:
                spec[off + 2] = "model"
            elif T % m == 0:
                spec[off + 1] = "model"
        elif name.endswith("C") and len(shape) - off == 4:
            spec[off + 1] = "model" if shape[off + 1] % _axis_size(
                mesh, "model") == 0 else None
        return _fit_spec(spec, shape, mesh)

    return _map_paths(rule, states)


# ---------------------------------------------------------------------------
# training: the mesh of ranks
# ---------------------------------------------------------------------------

TRAIN_AXES = ("pod", "data", "model")


class TrainMesh:
    """The training mesh: every rank of the default process group laid
    out over the ordered axes ``shape`` (a subsequence of ``pod``,
    ``data``, ``model``; ``model`` fastest, as ``jax.make_mesh`` orders
    devices). Built by :func:`train_mesh` on every rank, since group
    creation is collective: one group a line of each proper subset of
    the axes (the dp axes together, ``pod`` and ``model`` for a
    pipeline's clip norm, ...) and the world, created in the same order
    on every rank. ``coords``: this rank's index on each
    axis; ``device``: its device."""

    def __init__(self, shape: Dict[str, int], device):
        self.shape = dict(shape)
        self.axes = tuple(self.shape)
        self.rank, n = world()
        if math.prod(self.shape.values()) != n:
            raise ValueError(f"mesh {self.shape} needs "
                             f"{math.prod(self.shape.values())} ranks, the "
                             f"group has {n}")
        self.device = torch.device(device)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        sizes = tuple(self.shape.values())
        self.coords = dict(zip(self.axes, (int(c) for c in np.unravel_index(
            self.rank, sizes))))
        grid = np.arange(n).reshape(sizes)
        self._groups: Dict[tuple, Any] = {}
        subsets = [sub for r in range(1, len(self.axes))
                   for sub in itertools.combinations(self.axes, r)]
        for sub in subsets:
            keep = [i for i, a in enumerate(self.axes) if a in sub]
            rest = [i for i in range(len(self.axes)) if i not in keep]
            lines = np.transpose(grid, rest + keep).reshape(
                -1, math.prod(sizes[i] for i in keep))
            for line in lines:
                g = _new_group(line.tolist()) if n > 1 else None
                if self.rank in line:
                    self._groups[sub] = g
        self._groups[self.axes] = (dist.group.WORLD if n > 1 else None)

    def __repr__(self) -> str:
        return (f"TrainMesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")

    def size(self, axes) -> int:
        return _axis_size(self, axes)

    def group(self, axes):
        """The group of this rank's line along ``axes`` (an axis name or
        a tuple of them; None for a line of one rank). Axes of size 1 drop
        out."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        axes = tuple(a for a in self.axes if a in axes
                     and self.shape[a] > 1)
        if not axes:
            return None
        return self._groups[axes]

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (row-major over them)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        idx = 0
        for a in self.axes:
            if a in axes:
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    @property
    def model(self) -> int:
        return self.shape.get("model", 1)

    def rank_plan(self, cfg: ModelConfig, shapes) -> Optional[RankPlan]:
        """The ``RankPlan`` of the layer runners on this rank (the model
        group of each sharded block kind, and with ``data > 1`` the data
        group and the FSDP dims of the whole tree ``shapes``,
        :func:`tree_shapes`), or None on a mesh of neither."""
        m, d = self.model, self.shape.get("data", 1)
        if m == 1 and d == 1:
            return None
        plan = _plan(cfg, m, self.group("model"))
        if d > 1:
            plan = plan._replace(data=self.group("data"), fsdp=fsdp_dims(
                cfg, _split_sizes(self), shapes))
        return plan

    def local_cfg(self, cfg: ModelConfig) -> ModelConfig:
        return local_cfg(cfg, self.model)

    def local_batch(self, batch: Dict[str, Any], axes) -> Dict[str, Any]:
        """This rank's slice of each batch tensor along its leading axis
        over ``axes`` (the batch spec's first entry; None: the whole
        batch)."""
        n = self.size(axes) if axes else 1
        if n == 1:
            return batch
        i = self.index(axes)
        out = {}
        for k, v in batch.items():
            per = v.shape[0] // n
            out[k] = v[i * per:(i + 1) * per]
        return out


def train_mesh(model: int = 1, *, pod: int = 1, device=None) -> TrainMesh:
    """The ``(pod?, data, model)`` mesh over every rank of the initialized
    default group: data = world / (pod * model), ``pod`` only where over 1.
    Call it on every rank. Rank r runs on ``cuda:r`` unless ``device`` is
    given. Raises ``ValueError`` where pod * model does not divide the
    world."""
    rank, n = world()
    if model < 1 or pod < 1 or n % (model * pod) != 0:
        raise ValueError(f"{n} ranks not divisible by mp={model} x "
                         f"pod={pod}")
    shape = {"pod": pod} if pod > 1 else {}
    shape.update(data=n // (model * pod), model=model)
    return TrainMesh(shape, _rank_device(rank, device))


def _layer_kind(path: str, cfg: ModelConfig) -> str:
    """The block kind a layer leaf belongs to: "mlp" under ``mlp/``, else
    its layer's mixer kind."""
    if "/mlp/" in path:
        return "mlp"
    if cfg.homogeneous:
        return cfg.block_kind(0)
    return cfg.block_kind(int(path.split("/")[1]))


def _rank_spec(path: str, shape, cfg: ModelConfig, sizes: Dict[str, int]
               ) -> tuple:
    """The port's layout of one leaf of whole shape ``shape`` on a mesh of
    axis ``sizes``: its rule (``_PORT_RULES``, then ``_PARAM_RULES``, MoE
    experts on their d / f dims where E does not divide), each model entry
    kept only in a layer whose block kind splits, each data entry where
    data > 1, and every entry whose dim the axis does not divide dropped
    (``_fit_spec``)."""
    m, d = sizes.get("model", 1), sizes.get("data", 1)
    stacked = cfg.homogeneous and path.startswith("layers/")
    base = len(shape) - (1 if stacked else 0)
    spec: tuple = ()
    for pat, rule in _PORT_RULES + _PARAM_RULES:
        if re.search(pat, path):
            spec = rule.get(base, ()) if isinstance(rule, dict) else rule
            if "mlp/w_" in path and not path.endswith("/w") \
                    and cfg.n_experts % m != 0:
                spec = ((None, "model", "data") if path.endswith("w_down")
                        else (None, "data", "model"))
            break
    splits = (path.startswith("layers/") and m > 1
              and check_model_parallel(cfg, m)[_layer_kind(path, cfg)])
    spec = tuple(a if (a == "model" and splits) or (a == "data" and d > 1)
                 else None for a in spec)
    if stacked:
        spec = (None, *spec)
    return _fit_spec(spec, shape, types.SimpleNamespace(shape=sizes))


def tree_shapes(tree) -> Tuple[Tuple[str, Tuple[int, ...], Any], ...]:
    """(path, shape, dtype) of each leaf of a parameter tree: the whole
    tree's are what a layout is computed from (:func:`rank_specs`;
    ``core.split.param_shapes`` gives a config's without making it)."""
    return tuple((path, tuple(a.shape), a.dtype)
                 for path, a in _path_leaves(tree))


@functools.lru_cache(maxsize=64)
def rank_specs(cfg: ModelConfig, sizes: Tuple[Tuple[str, int], ...],
               shapes) -> Mapping[str, tuple]:
    """{path: spec} of every leaf of the whole tree ``shapes``
    (:func:`tree_shapes`) on a mesh of axis ``sizes`` ((axis, size)
    pairs): the layout :func:`shard_train_params` and :func:`shard_params`
    cut. A path not in it replicates. Cached, so read-only."""
    sz = dict(sizes)
    return types.MappingProxyType({
        path: _rank_spec(path, shape, cfg, sz) for path, shape, _ in shapes})


def _local_slices(params, cfg: ModelConfig, sizes, coords: Dict[str, int]):
    """Each leaf of the whole tree ``params`` cut along every axis of its
    spec (``rank_specs`` on ``sizes``; contiguous copies) at this rank's
    ``coords``; every other leaf shared with ``params``."""
    specs = rank_specs(cfg, tuple(sizes), tree_shapes(params))
    sz = dict(sizes)

    def one(path, leaf):
        spec = specs.get(path, ())
        if not any(spec):
            return leaf
        for dim, axis in enumerate(spec):
            if axis is not None:
                n = leaf.shape[dim] // sz[axis]
                leaf = leaf.narrow(dim, coords[axis] * n, n)
        return leaf.contiguous()

    return _map_paths(one, params)


def fsdp_dims(cfg: ModelConfig, sizes, shapes) -> Dict[str, Dict]:
    """The data dim of each data-split leaf of the whole tree ``shapes`` on
    a mesh of axis ``sizes``: ``{"layers": {kind: {path in a layer:
    dim}}, "top": {path: dim}}`` (one layer's tree a block kind; the
    stacked axis not counted)."""
    specs = rank_specs(cfg, tuple(sizes), shapes)
    layers: Dict[str, Dict[str, int]] = {}
    top: Dict[str, int] = {}
    for path, spec in specs.items():
        if "data" not in spec:
            continue
        dim = spec.index("data")
        if not path.startswith("layers/"):
            top[path] = dim
            continue
        parts = path.split("/")
        if cfg.homogeneous:
            kind, rel, dim = cfg.block_kind(0), "/".join(parts[1:]), dim - 1
        else:
            kind, rel = cfg.block_kind(int(parts[1])), "/".join(parts[2:])
        layers.setdefault(kind, {})[rel] = dim
    return {"layers": layers, "top": top}


def layout_bytes(cfg: ModelConfig, sizes, shapes) -> Dict[str, int]:
    """A rank's bytes of the whole tree ``shapes``' parameters ("params")
    and of their AdamW moments ("adam": float32 m and v) under the layout
    of ``rank_specs(cfg, sizes, shapes)``."""
    sz = dict(sizes)
    specs = rank_specs(cfg, tuple(sizes), shapes)
    out = {"params": 0, "adam": 0}
    for path, shape, dtype in shapes:
        n = math.prod(shape) // math.prod(sz[x] for x in specs[path] if x)
        out["params"] += n * dtype.itemsize
        out["adam"] += 8 * n
    return out


def fsdp_gather(tree, dims: Dict[str, int], group):
    """``tree`` with each leaf at a path of ``dims`` gathered whole over
    ``group`` along its dim (``collectives.all_gather``, exact; its
    backward the reduce-scatter of the gradient)."""
    return _map_paths(lambda path, a: a if path not in dims
                      else CL.all_gather(a, group, dims[path]), tree)


def fsdp_gather_layer(p, kind: str, plan: Optional[RankPlan]):
    """A layer's tree ``p`` (of block kind ``kind``) with its data-split
    weights gathered over the plan's data group; as it is without one."""
    if plan is None or plan.data is None:
        return p
    return fsdp_gather(p, plan.fsdp["layers"].get(kind, {}), plan.data)


def fsdp_gather_top(params, plan: Optional[RankPlan]):
    """``params`` with the data-split leaves outside ``layers`` (an untied
    LM head, the bottleneck bank) gathered over the plan's data group; as
    it is without one. The layers gather theirs one at a time
    (``T.block_apply_full``)."""
    if plan is None or plan.data is None or not plan.fsdp["top"]:
        return params
    rest = fsdp_gather({k: v for k, v in params.items() if k != "layers"},
                       plan.fsdp["top"], plan.data)
    return {**params, **rest}


def _stage_slices(params, cfg: ModelConfig, n_stages: int, stage: int):
    """``params`` with its stacked layer leaves cut to ``stage``'s
    contiguous ``L / n_stages`` layers (views)."""
    if not cfg.homogeneous or cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.name}: the pod pipeline needs a homogeneous "
                         f"stack of a multiple of {n_stages} layers")
    per = cfg.n_layers // n_stages
    out = dict(params)
    out["layers"] = _map_paths(lambda _, a: a[stage * per:(stage + 1) * per],
                               params["layers"])
    return out


def shard_train_params(params, mesh: TrainMesh, *, cfg: ModelConfig,
                       stages: bool = False):
    """The rank's parameter tree: each leaf's slice along the model entry
    of its spec where its block shards and along its data entry where
    data > 1 (``rank_specs``), and with ``stages`` (the pod pipeline) only
    this pod rank's contiguous part of the layers. Whole leaves are shared
    with ``params``."""
    if stages:
        params = _stage_slices(params, cfg, mesh.shape["pod"],
                               mesh.coords["pod"])
    if mesh.model == 1 and mesh.shape.get("data", 1) == 1:
        return params
    return _local_slices(params, cfg, _split_sizes(mesh), mesh.coords)


def _split_sizes(mesh: TrainMesh) -> Tuple[Tuple[str, int], ...]:
    return tuple((a, mesh.shape[a]) for a in ("data", "model")
                 if a in mesh.shape)


def gather_train_params(local, mesh: TrainMesh, *, cfg: ModelConfig,
                        shapes, stages: bool = False):
    """The whole tree (of :func:`tree_shapes` ``shapes``) on every rank
    from the ranks' ``shard_train_params`` slices, bit for bit (each split
    leaf gathered exactly over the model and the data groups, and with
    ``stages`` the layers over pod)."""
    specs = rank_specs(cfg, _split_sizes(mesh), shapes)

    def one(path, leaf):
        for dim, axis in enumerate(specs.get(path, ())):
            if axis is not None:
                leaf = CL.gather_raw(leaf.contiguous(), mesh.group(axis),
                                     dim)
        return leaf

    local = _map_paths(one, local)
    if stages:
        group = mesh.group("pod")
        local = dict(local)
        local["layers"] = _map_paths(
            lambda _, a: CL.gather_raw(a.contiguous(), group, 0),
            local["layers"])
    return local


def split_axes(params, mesh: TrainMesh, *, cfg: ModelConfig, shapes,
               stages: bool = False):
    """The rank's parameter tree with, at each leaf, the mesh axes its
    slice is split over (in the mesh's order: ``("data",)``,
    ``("model",)``, ``("data", "model")``; with ``stages`` ``"pod"`` first
    for the layers), or None where it is whole: what the clip's global
    norm sums over (``optimizer.apply_updates``) and what the train step
    reduces a gradient over. Reads paths only (a gradient tree with None
    leaves will do); ``shapes``: the whole tree's (:func:`tree_shapes`)."""
    specs = rank_specs(cfg, _split_sizes(mesh), shapes)

    def one(path, _):
        on = set(specs.get(path, ())) - {None}
        axes = ("pod",) if stages and path.startswith("layers/") else ()
        axes += tuple(a for a in mesh.axes if a in on)
        return axes or None

    return _map_paths(one, params)
