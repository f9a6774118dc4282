"""The serving mesh of the port: ``(dp, mp)`` ranks of ``torch.distributed``
(the serving half of ``repro.models.sharding``).

The reference drives every device of a ``('dp', 'mp')`` mesh from one
process under ``jit``. Here each rank is one process of a
``torch.distributed`` process group and a :class:`ServingMesh` says what
this rank does:

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
  axis splits with them. An attention block shards only where ``n_kv %
  mp == 0`` and an MLP only where ``d_ff % mp == 0``; otherwise that block
  runs replicated on every rank. The embedding, the final norm, the LM
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

Only ``all_reduce`` and ``broadcast`` are used, which both NCCL and gloo
take on CUDA tensors. ``mesh=None`` everywhere is the one-device engine,
unchanged. The training half of the reference file (FSDP specs,
activation rules, expert parallelism) is not here.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig

#: ROADMAP item that brings mp to the layers this slice keeps replicated
MP_LATER = ("ROADMAP Queue 1 item 7b (training and MoE across devices) "
            "brings mp to MoE expert layers, RG-LRU and xLSTM mixers")

#: KV-cache leaf names (last path component), sharded over mp by head
KV_LEAVES = frozenset({"k", "v", "k_s", "v_s"})

# (regex on the '/'-joined path below a layer, axis counted from the end
# of the leaf: -1 columns, -2 rows, "attn" / "mlp" the block it needs)
_PARAM_RULES = (
    (r"mix/w[qkv]/w$", -1, "attn"),
    (r"mix/w[qkv]/b$", -1, "attn"),
    (r"mix/wo/w$", -2, "attn"),
    (r"mlp/w_(gate|up)/w$", -1, "mlp"),
    (r"mlp/w_down/w$", -2, "mlp"),
)


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
        """mp > 1 shards only the dense attention archs' attention and MLP
        layers: MoE expert layers, RG-LRU and xLSTM mixers raise."""
        if self.mp == 1:
            return
        kinds = {cfg.block_kind(i) for i in range(cfg.n_layers)}
        what = [w for w, bad in (("MoE expert layers", cfg.is_moe),
                                 ("RG-LRU mixers", "rglru" in kinds),
                                 ("xLSTM mixers", bool(kinds & {"mlstm",
                                                               "slstm"})))
                if bad]
        if what:
            raise NotImplementedError(
                f"{cfg.name}: mp={self.mp} over {', '.join(what)} is not "
                f"ported: {MP_LATER}")

    def attn_sharded(self, cfg: ModelConfig) -> bool:
        return self.mp > 1 and cfg.n_kv_heads % self.mp == 0

    def mlp_sharded(self, cfg: ModelConfig) -> bool:
        return self.mp > 1 and bool(cfg.d_ff) and cfg.d_ff % self.mp == 0

    def rank_plan(self, cfg: ModelConfig) -> Optional[RankPlan]:
        """The ``RankPlan`` of ``T.run_layers_*`` on this rank, or None at
        mp 1."""
        if not self.member or self.mp == 1:
            return None
        return RankPlan(
            self.mp_group if self.attn_sharded(cfg) else None,
            self.mp_group if self.mlp_sharded(cfg) else None)

    def local_cfg(self, cfg: ModelConfig) -> ModelConfig:
        """The rank's config: head counts and ``d_ff`` over mp where those
        blocks shard. ``dataclasses.replace`` keeps the full config's
        ``head_dim`` (a config built anew would derive it from the narrowed
        head count)."""
        kw: Dict[str, int] = {}
        if self.attn_sharded(cfg):
            kw.update(n_heads=cfg.n_heads // self.mp,
                      n_kv_heads=cfg.n_kv_heads // self.mp,
                      head_dim=cfg.head_dim)
        if self.mlp_sharded(cfg):
            kw["d_ff"] = cfg.d_ff // self.mp
        return dataclasses.replace(cfg, **kw) if kw else cfg

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
    """(axis from the end, block) of the mp rule a parameter path matches,
    or None: replicated."""
    for pat, axis, block in _PARAM_RULES:
        if re.search(pat, path):
            return axis, block
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
    """The rank's parameter tree: each split matrix's slice (a contiguous
    copy: the columns or rows of this mp rank's heads or ``d_ff`` part),
    every replicated tensor shared with ``params``. Stacked ``[L, ...]``
    leaves keep their leading axis. No-op without a mesh or at mp 1."""
    if mesh is None or mesh.mp == 1:
        return params
    mesh.check_model(cfg)
    sharded = {"attn": mesh.attn_sharded(cfg), "mlp": mesh.mlp_sharded(cfg)}
    m = mesh.coords[1]

    def one(path, leaf):
        rule = param_rule(path) if path.startswith("layers") else None
        if rule is None or not sharded[rule[1]]:
            return leaf
        axis = leaf.dim() + rule[0]
        n = leaf.shape[axis] // mesh.mp
        return leaf.narrow(axis, m * n, n).contiguous()

    return _map_paths(one, params)


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
