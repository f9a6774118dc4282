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
block shards (attention where ``n_kv % model == 0``, a dense MLP where
``d_ff % model == 0``, MoE experts where ``E % model == 0``, else each
expert's f axis where ``d_ff % model == 0``; otherwise the block runs
replicated). The ``data`` entries are not applied: weights and AdamW state
replicate over the dp axes (the reference's FSDP over ``data`` is ROADMAP
item 7c), and the batch splits by :func:`batch_pspec`. The embedding, the
final norm, the LM head and the bottleneck bank replicate over model, as
in serving. The residual replicates over model whatever ``act_policy``
says (the reference's ``seq`` policy shards it under GSPMD; the quantized
prefill, ``core/qtp.py``, runs the sequence-parallel schedule itself).

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
  every rank. RG-LRU and xLSTM mixers raise at mp > 1 (ROADMAP item 7c).
  The embedding, the final norm, the LM
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
import itertools
import math
import re
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig

#: ROADMAP item that brings mp to the layers the meshes keep whole
MP_LATER = ("ROADMAP Queue 1 item 7c brings mp to RG-LRU and xLSTM "
            "mixers")

#: KV-cache leaf names (last path component), sharded over mp by head
KV_LEAVES = frozenset({"k", "v", "k_s", "v_s"})

class RankPlan(NamedTuple):
    """What a rank's model calls need of the mesh: the mp groups of its
    blocks, the attention block's and the MLP's (None where that block runs
    replicated)."""
    attn: Any = None
    mlp: Any = None


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

def check_model_parallel(cfg: ModelConfig, m: int) -> None:
    """Raise ``NotImplementedError`` for a model axis over 1 on an arch
    with RG-LRU or xLSTM mixers (naming ROADMAP item 7c)."""
    if m == 1:
        return
    kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
    what = [w for w, bad in (("RG-LRU mixers", "rglru" in kinds),
                             ("xLSTM mixers", bool(kinds & {"mlstm",
                                                           "slstm"})))
            if bad]
    if what:
        raise NotImplementedError(
            f"{cfg.name}: mp={m} over {', '.join(what)} is not ported: "
            f"{MP_LATER}")


def attn_sharded(cfg: ModelConfig, m: int) -> bool:
    """Attention splits its heads over ``m`` ranks where ``n_kv % m ==
    0``."""
    return m > 1 and cfg.n_kv_heads % m == 0


def mlp_sharded(cfg: ModelConfig, m: int) -> bool:
    """A dense MLP splits where ``d_ff % m == 0``; a MoE layer where its
    experts (``E % m == 0``) or each expert's f axis divide."""
    if m == 1 or not cfg.d_ff:
        return False
    if cfg.is_moe and cfg.n_experts % m == 0:
        return True
    return cfg.d_ff % m == 0


def local_cfg(cfg: ModelConfig, m: int) -> ModelConfig:
    """The rank's config at ``m`` model ranks: head counts and a dense
    MLP's ``d_ff`` over ``m`` where those blocks shard (a MoE layer reads
    its sizes from its weights). ``dataclasses.replace`` keeps the full
    config's ``head_dim`` (a config built anew would derive it from the
    narrowed head count)."""
    kw: Dict[str, int] = {}
    if attn_sharded(cfg, m):
        kw.update(n_heads=cfg.n_heads // m, n_kv_heads=cfg.n_kv_heads // m,
                  head_dim=cfg.head_dim)
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
    def check_model(self, cfg: ModelConfig) -> None:
        """mp > 1 shards attention, dense MLP and MoE layers: RG-LRU and
        xLSTM mixers raise (``check_model_parallel``)."""
        check_model_parallel(cfg, self.mp)

    def attn_sharded(self, cfg: ModelConfig) -> bool:
        return attn_sharded(cfg, self.mp)

    def mlp_sharded(self, cfg: ModelConfig) -> bool:
        return mlp_sharded(cfg, self.mp)

    def rank_plan(self, cfg: ModelConfig) -> Optional[RankPlan]:
        """The ``RankPlan`` of ``T.run_layers_*`` on this rank, or None at
        mp 1."""
        if not self.member or self.mp == 1:
            return None
        return RankPlan(
            self.mp_group if self.attn_sharded(cfg) else None,
            self.mp_group if self.mlp_sharded(cfg) else None)

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


def param_rule(path: str):
    """(axis from the end, block: "attn" or "mlp") of the model entry of a
    layer leaf's rule (``_PARAM_RULES``, at the leaf's rank without the
    stacked axis), or None: replicated (every leaf outside ``layers``)."""
    if not path.startswith("layers/"):
        return None
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            if isinstance(spec, dict):
                spec = spec[2]
            if "model" not in spec:
                return None
            return (spec.index("model") - len(spec), _layer_block(path))
    return None


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
    copy: the columns or rows of this mp rank's heads or ``d_ff`` part, or
    its experts), every replicated tensor shared with ``params``. Stacked
    ``[L, ...]`` leaves keep their leading axis. No-op without a mesh or
    at mp 1."""
    if mesh is None or mesh.mp == 1:
        return params
    mesh.check_model(cfg)
    return _model_slices(params, cfg, mesh.mp, mesh.coords[1])


def shard_state(states, mesh: Optional[ServingMesh], cfg: ModelConfig):
    """This mp rank's head slice of every KV leaf of a full-head decode
    state (the layout ``T.init_decode_state`` makes for the full config)
    where attention shards; other leaves as they are."""
    if mesh is None or not mesh.attn_sharded(cfg) or not mesh.member:
        return states
    n = cfg.n_kv_heads // mesh.mp
    m = mesh.coords[1]
    return _map_paths(
        lambda path, a: (a.narrow(a.dim() - 2, m * n, n)
                         if path.rsplit("/", 1)[-1] in KV_LEAVES else a),
        states)


def unshard_state(local, mesh: ServingMesh, cfg: ModelConfig, full_like,
                  holds: bool):
    """The full-head state on every rank of the scope from its holders'
    parts. ``holds``: this rank writes its part (``local``, ignored
    otherwise): one holder of each slot's shard, every mp rank of it for
    the head-split KV leaves, mp rank 0 for the rest. ``full_like``: a tree
    of the full shapes and dtypes (e.g. on the meta device). Exact: each
    leaf is an integer sum of zero-padded parts."""
    split = mesh.attn_sharded(cfg)
    mp_idx = mesh.coords[1] if mesh.member else 0
    n = cfg.n_kv_heads // mesh.mp if split else 0
    parts = dict(_path_leaves(local)) if holds else {}

    def one(path, meta):
        kv = split and path.rsplit("/", 1)[-1] in KV_LEAVES
        buf = torch.zeros(meta.shape, dtype=meta.dtype, device=mesh.device)
        if holds and (kv or mp_idx == 0):
            dst = buf.narrow(buf.dim() - 2, mp_idx * n, n) if kv else buf
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

    def rank_plan(self, cfg: ModelConfig) -> Optional[RankPlan]:
        """The ``RankPlan`` of the layer runners on this rank (the model
        group of each sharded block), or None at model 1."""
        m = self.model
        if m == 1:
            return None
        check_model_parallel(cfg, m)
        g = self.group("model")
        return RankPlan(g if attn_sharded(cfg, m) else None,
                        g if mlp_sharded(cfg, m) else None)

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


def _layer_block(path: str) -> str:
    return "attn" if "mix/" in path else "mlp"


def _model_axis(path: str, ndim: int, cfg: ModelConfig, m: int):
    """The axis of a layer leaf that the model entry of its rule splits
    (the spec ``param_pspecs`` gives the whole leaf on a mesh with ``m``
    model ranks), where its block shards; None otherwise."""
    if not path.startswith("layers/") or m == 1:
        return None
    block = _layer_block(path)
    if not (attn_sharded(cfg, m) if block == "attn"
            else mlp_sharded(cfg, m)):
        return None
    stacked = cfg.homogeneous
    base = ndim - (1 if stacked else 0)
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            if isinstance(spec, dict):
                spec = spec.get(base, ())
            if "mlp/w_" in path and not path.endswith("/w") \
                    and cfg.n_experts % m != 0:
                spec = ((None, "model", "data") if path.endswith("w_down")
                        else (None, "data", "model"))
            if "model" not in spec:
                return None
            return spec.index("model") + (1 if stacked else 0)
    return None


def _model_slices(params, cfg: ModelConfig, m: int, coord: int):
    """Each layer leaf's ``coord``-th of ``m`` slices along its model axis
    (``_model_axis``; contiguous copies); every other leaf shared with
    ``params``."""
    def one(path, leaf):
        axis = _model_axis(path, leaf.dim(), cfg, m)
        if axis is None:
            return leaf
        n = leaf.shape[axis] // m
        return leaf.narrow(axis, coord * n, n).contiguous()

    return _map_paths(one, params)


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
    """The rank's parameter tree: each layer leaf's slice along the model
    entry of its spec (``param_pspecs``) where its block shards, and with
    ``stages`` (the pod pipeline) only this pod rank's contiguous half of
    the layers. Replicated leaves are shared with ``params``."""
    if stages:
        params = _stage_slices(params, cfg, mesh.shape["pod"],
                               mesh.coords["pod"])
    m = mesh.model
    if m == 1:
        return params
    check_model_parallel(cfg, m)
    return _model_slices(params, cfg, m, mesh.coords["model"])


def gather_train_params(local, mesh: TrainMesh, *, cfg: ModelConfig,
                        stages: bool = False):
    """The whole tree on every rank from the ranks' ``shard_train_params``
    slices, bit for bit (each split leaf gathered exactly over the model
    group, and with ``stages`` the layers over pod)."""
    from repro_torch.models import collectives as CL
    m = mesh.model
    if m > 1:
        group = mesh.group("model")

        def one(path, leaf):
            axis = _model_axis(path, leaf.dim(), cfg, m)
            return leaf if axis is None else CL.gather_raw(leaf, group,
                                                            axis)

        local = _map_paths(one, local)
    if stages:
        group = mesh.group("pod")
        local = dict(local)
        local["layers"] = _map_paths(
            lambda _, a: CL.gather_raw(a.contiguous(), group, 0),
            local["layers"])
    return local


def split_axes(params, mesh: TrainMesh, *, cfg: ModelConfig,
               stages: bool = False):
    """The rank's parameter tree with, at each leaf, the mesh axes its
    slice is split over (``("model",)``, with ``stages`` ``("pod",)`` or
    ``("pod", "model")`` for the layers), or None where it is whole: what
    the clip's global norm sums over (``optimizer.apply_updates``)."""
    m = mesh.model

    def one(path, leaf):
        axes = ("pod",) if stages and path.startswith("layers/") else ()
        if _model_axis(path, leaf.dim(), cfg, m) is not None:
            axes += ("model",)
        return axes or None

    return _map_paths(one, params)
