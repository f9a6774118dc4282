"""Continuous-batching split serving (mirrors ``repro.serving.batcher``:
the mixed-mode split steps, the bank-free ones and both window bodies).

The engine keeps ``n_slots`` decode slots over one of two pools: the paged
pool (ONE global page arena per KV leaf, the default for homogeneous
full-attention archs) or the dense ``SlotPool`` (per-slot rolling caches
and recurrent carries, the default for windowed and recurrent archs).
Every engine tick it:

1. admits pending requests into free slots (under a page budget on the
   paged pool: a request whose worst-case page count does not fit PARKS at
   the queue head), and prefills the new prompts in one batched forward per
   power-of-two length bucket, each row's boundary routed through its
   admission-chosen mode;
2. steps each live session's own simulated channel and picks its
   bottleneck mode (per-tick orchestrator, adaptive ``ModeController``, or
   admission-frozen) for every tick of the next decode window — mode choice
   depends only on channel observations and token counts, never on token
   values, so whole windows are decidable up front;
3. runs the window: K mixed-mode decode ticks back to back on the device,
   each ending in the fused norm / LM-head / argmax tail whose token feeds
   the next tick, and reads the window's tokens back one window late (the
   host's bookkeeping for window t+1 overlaps the device's work on window
   t). On one CUDA device the window is one replay of a CUDA graph of its
   K ticks (``serving/graphs.py``, the counterpart of the reference's
   compiled ``lax.scan``), keyed by (K, block-table width, ``fused_tail``,
   banked); its inputs are static buffers written in place before the
   replay (tokens, positions, the mode rows, one block table a width) and
   its tokens land in a static output, copied to pinned host memory after
   the replay and read once that window's event has fired. On the CPU the
   same body runs uncaptured over the same buffers;
4. accounts wire bytes and simulated transfer latency per request and
   retires finished sessions at dispatch time.

``host_loop=True`` keeps the synchronous per-tick loop (logits + argmax
read back every tick) as the equivalence oracle; both loops decode
identical token streams. ``fused_tail=False`` ends each window tick in
the logits + argmax chain instead of the fused tail: the oracle the
fused window's tokens are held against. Both oracles, and every window
on a serving mesh (its collectives cannot be captured), run the ticks
eagerly.

Params without a bottleneck bank (no ``bneck_modes``) run the bank-free
steps, as the reference's "mono" steps: ``T.decode_step`` and
``T.prefill`` of the unsplit model (the boundary crosses raw), every
tick accounted on mode 0. Audio archs carry ``[K, 1]`` tokens a slot and
``[K, S]`` prompts; a session records codebook 0's token.

``telemetry=`` (a :class:`~repro_torch.serving.telemetry.Telemetry`)
records the reference's host events and histograms (admission verdicts,
prefill spans, mode switches and escalations, decode-window spans, TTFT and
inter-token latency) and folds the per-tick int32 telemetry block
``[wire_bytes, live_slots, mode_hist...]`` into ``device_tel`` one window
late; it changes no token. Live migration between engines
(``serving/migration.py``) reads and writes the pools through
``read_rows`` / ``write_rows`` (dense) and ``read_pages`` / ``write_pages``
(paged). ``mesh=`` runs the engine over the ranks of a serving mesh
(``models.sharding``).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bottleneck
from repro_torch.core import split as SP
from repro_torch.core.channel import Channel, tx_seconds
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.serving.controller import ModeController
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.session import Request, RequestQueue, Session
from repro_torch.serving.telemetry import Telemetry, now as _now


def _bucket_len(n: int, lo: int = 8) -> int:
    """Pad ``n`` up to the next power-of-two bucket (>= ``lo``)."""
    b = lo
    while b < n:
        b <<= 1
    return b


def _group_by_bucket(admits):
    """Group (req, slot, mode, ...) admissions by prompt-length bucket."""
    groups: Dict[int, list] = {}
    for a in admits:
        groups.setdefault(_bucket_len(a[0].prompt_len), []).append(a)
    return groups


def _slot_axis(cfg: ModelConfig) -> int:
    # homogeneous archs stack per-layer states into [L, B, ...] leaves;
    # heterogeneous archs keep a tuple of per-layer [B, ...] trees
    return 1 if cfg.homogeneous else 0


def scatter_rows(pool_states, batch_states, idx, axis: int):
    """Write rows 0..len(idx)-1 of a batched state tree into the pool rows
    ``idx`` (distinct), in place on the pool's device."""
    n = idx.shape[0]
    for p, b in zip(T.tree_leaves(pool_states), T.tree_leaves(batch_states)):
        p.index_copy_(axis, idx, b.narrow(axis, 0, n).to(p.dtype))


def gather_rows(pool_states, idx, axis: int):
    """The gather inverse of :func:`scatter_rows`: rows ``idx`` of the pool
    as a batched state tree with batch ``len(idx)`` on ``axis``."""
    return T.tree_map(lambda p: p.index_select(axis, idx), pool_states)


def _admit_meta(positions, cur_tokens, slots, pos_vals, first_tokens):
    """Device-loop admission of the slots' positions and first tokens,
    written in place (``index_copy_``: the counterpart of the reference's
    donated scatter), so the window graphs' static inputs keep their
    addresses. The state rows go in first: the paged prefill writes the
    arena through the group's block tables, a dense pool takes them
    through ``SlotPool.write_rows``."""
    n = slots.shape[0]
    positions.index_copy_(0, slots, pos_vals.to(positions.dtype))
    cur_tokens.index_copy_(0, slots, first_tokens[:n].reshape(
        (n,) + tuple(cur_tokens.shape[1:])).to(cur_tokens.dtype))


class _Staging:
    """Host buffers of one window in flight: its mode rows, block table and
    tokens, pinned on the card so their copies are asynchronous, and the
    event recorded after the window's token copy. Two alternate: window n
    reuses window n - 2's, which was read (its event waited on) before
    window n is staged."""

    def __init__(self, max_window: int, n_slots: int, tok_shape: tuple,
                 table: int, device):
        pin = device.type == "cuda"
        i32 = dict(dtype=torch.int32, pin_memory=pin)
        self.modes = torch.zeros((max_window, n_slots), **i32)
        self.table = torch.zeros(table, **i32)
        self.toks = torch.zeros((max_window,) + tok_shape, **i32)
        self.event = torch.cuda.Event() if pin else None


class _Rows:
    """Where a pool's slots live on a serving mesh: this rank holds slots
    [lo, hi) (all of them without a mesh; none off the engine group). A
    rank of the engine group decodes every slot's row, in its place, as
    one device does (``sharding.ServingMesh`` says why); a slot it does not
    hold decodes on scratch state."""

    def __init__(self, n_slots: int, mesh):
        self.lo, self.hi = (mesh.slot_rows(n_slots) if mesh is not None
                            else (0, n_slots))
        #: this rank decodes (every slot's row on the engine group)
        self.decodes = mesh is None or mesh.member
        #: this rank writes its rows into exchanges of the whole pool: one
        #: holder of each shard (dp rank 0 where the slot axis replicates)
        self.holds = mesh is None or (
            mesh.member and (mesh.slot_shards(n_slots) > 1
                             or mesh.coords[0] == 0))

    def local(self, slots) -> Tuple[List[int], List[int]]:
        """(positions in ``slots``, the slots) of the slots held here."""
        pairs = [(i, int(s)) for i, s in enumerate(slots)
                 if self.lo <= int(s) < self.hi]
        return [i for i, _ in pairs], [r for _, r in pairs]


def _mp(mesh) -> int:
    """The model ranks a pool's state splits over (1 without a mesh)."""
    return mesh.mp if mesh is not None else 1


class SlotPool:
    """Fixed pool of decode slots with recycled dense state: per-slot
    rolling KV caches and recurrent carries (RG-LRU, mLSTM, sLSTM; the
    xLSTM stabiliser starts at -inf), written in place on the device.

    ``mesh``: a serving mesh; the rank holds its dp shard's slots (and its
    mp rank's KV heads) and writes only those; its pool has every slot's
    row, in its place, since the rank decodes every row (the others'
    state is scratch). The host bookkeeping covers every slot."""

    paged = False

    def __init__(self, cfg: ModelConfig, n_slots: int, cache_len: int, *,
                 device=None, mesh=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.device = device
        self.mesh = mesh
        self.rows = _Rows(n_slots, mesh)
        self.states = (T.init_decode_state(cfg, n_slots, cache_len,
                                           device=device, mp=_mp(mesh))
                       if self.rows.decodes else None)
        self.positions = np.zeros(n_slots, np.int32)
        self._free = list(range(n_slots - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, slot: int):
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if slot in self._free:
            raise ValueError(f"double release of slot {slot}")
        self.positions[slot] = 0
        self._free.append(slot)

    def _idx(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def write_rows(self, batch_states, slots, positions, *,
                   full_heads: bool = False):
        """Install rows 0..len(slots)-1 of a freshly prefilled batched state
        into the given slots (full overwrite of the previous occupant); on
        a mesh, only the slots this rank holds. ``full_heads``: the rows
        carry every KV head (a migrated snapshot), of which this rank keeps
        its own."""
        for s, p in zip(slots, positions):
            self.positions[s] = p
        which, rows = self.rows.local(slots)
        if not rows:
            return
        if full_heads:
            batch_states = sharding.shard_state(batch_states, self.mesh,
                                                self.cfg)
        axis = _slot_axis(self.cfg)
        src = self._idx(which)
        for p, b in zip(T.tree_leaves(self.states),
                        T.tree_leaves(batch_states)):
            p.index_copy_(axis, self._idx(rows),
                          b.index_select(axis, src).to(p.dtype))

    def read_rows(self, slots):
        """The given slots' decode state as a batched state tree, the shape
        ``write_rows`` accepts. On a mesh: every KV head, on every rank of
        the scope, gathered from the rows' holders (a collective)."""
        axis = _slot_axis(self.cfg)
        if self.mesh is None:
            return gather_rows(self.states, self._idx(slots), axis)
        full = T.init_decode_state(self.cfg, len(slots), self.cache_len,
                                   device="meta")
        local = None
        which, rows = self.rows.local(slots)
        if self.rows.holds:
            local = T.tree_map(lambda a: torch.zeros(
                a.shape[:axis] + (len(slots),) + a.shape[axis + 1:],
                dtype=a.dtype, device=self.device), self.states)
            if rows:
                for d, a in zip(T.tree_leaves(local),
                                T.tree_leaves(self.states)):
                    d.index_copy_(axis, self._idx(which),
                                  a.index_select(axis, self._idx(rows)))
        return sharding.unshard_state(local, self.mesh, self.cfg, full,
                                      self.rows.holds)


class PagedPool:
    """Paged decode-state pool: one global page arena per KV leaf, per-slot
    block tables, and a page free list.

    The arena holds ``n_pages + 1`` pages of ``page_len`` rows per leaf
    (``[L, n_pages + 1, page_len, n_kv, hd]``); page 0 is the reserved
    scratch page — free slots carry all-zero block-table rows, so their
    drifting decode writes land there and are never read unmasked. A slot's
    logical row ``t`` (== absolute position ``t``) lives at
    ``arena[block_np[slot, t // page_len], t % page_len]``.

    ``commit_pages`` reserves a session's worst-case page count at
    admission and ``pages_available`` subtracts every resident session's
    undrawn reservation, so on-demand ``alloc_pages`` growth can always be
    satisfied.

    ``mesh``: a serving mesh. A slot's pages live on its own dp shard:
    each shard keeps its own arena (its own scratch page 0) and its own
    free list over shard-local page ids, the ``n_pages`` split between the
    shards (so the pages that can be allocated in all are the unsharded
    pool's). Every shard's arena has the largest shard's page count; a
    shard with fewer carries padding pages that never enter its free list
    (the reference pads its one arena to a dp-divisible page count). A
    session draws only from its own shard's pages: at the default
    ``n_pages`` every slot has its full budget there."""

    paged = True

    def __init__(self, cfg: ModelConfig, n_slots: int, cache_len: int, *,
                 page_len: int = 8, n_pages: Optional[int] = None,
                 device=None, mesh=None):
        if not (T.full_attention_arch(cfg) and cfg.homogeneous):
            raise ValueError("paged pools need a homogeneous full-attention "
                             "arch")
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.page_len = page_len
        self.device = device
        self.mesh = mesh
        self.rows = _Rows(n_slots, mesh)
        per_slot = -(-cache_len // page_len)
        self.n_pages = n_pages if n_pages is not None else n_slots * per_slot
        #: arena rows — ONE session's max context (it may claim every page)
        self.capacity = self.n_pages * page_len
        self.n_shards = (mesh.slot_shards(n_slots) if mesh is not None
                         else 1)
        base, extra = divmod(self.n_pages, self.n_shards)
        #: allocatable pages of each shard (ids 1..shard_pages[j] there)
        self.shard_pages = [base + (j < extra) for j in range(self.n_shards)]
        self.arena_pages = max(self.shard_pages) + 1
        self.states = (T.init_decode_state(cfg, self.arena_pages,
                                           page_len, device=device,
                                           mp=_mp(mesh))
                       if self.rows.decodes else None)
        self.positions = np.zeros(n_slots, np.int32)
        self._free = list(range(n_slots - 1, -1, -1))
        self.block_np = np.zeros((n_slots, self.n_pages), np.int32)
        self.pages_used = np.zeros(n_slots, np.int32)
        self._committed = np.zeros(n_slots, np.int32)
        # pop -> 1, 2, ..
        self._free_pages = [list(range(n, 0, -1)) for n in self.shard_pages]
        self._free_page_set = [set(f) for f in self._free_pages]
        self.peak_pages_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    def acquire(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, slot: int):
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        if slot in self._free:
            raise ValueError(f"double release of slot {slot}")
        for i in range(int(self.pages_used[slot])):
            self._push_free_page(self._shard(slot),
                                 int(self.block_np[slot, i]))
        self.block_np[slot, :] = 0
        self.pages_used[slot] = 0
        self._committed[slot] = 0
        self.positions[slot] = 0
        self._free.append(slot)

    def _shard(self, slot: int) -> int:
        return (self.mesh.shard_of(slot, self.n_slots) if self.n_shards > 1
                else 0)

    @property
    def free_page_count(self) -> int:
        return sum(len(f) for f in self._free_pages)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - self.free_page_count

    def _available(self, shard: Optional[int]) -> int:
        sl = (slice(None) if shard is None else
              [s for s in range(self.n_slots) if self._shard(s) == shard])
        reserved = (int(self._committed[sl].sum())
                    - int(self.pages_used[sl].sum()))
        free = (self.free_page_count if shard is None
                else len(self._free_pages[shard]))
        return free - reserved

    @property
    def pages_available(self) -> int:
        """Pages a NEW admission may claim: the free list minus pages
        already committed to resident sessions but not drawn (on a mesh,
        those of the shard of the slot ``acquire`` gives next)."""
        if self.n_shards == 1:
            return self._available(None)
        if not self._free:
            return 0
        return self._available(self._shard(self._free[-1]))

    def _push_free_page(self, shard: int, page: int):
        if not 1 <= page <= self.shard_pages[shard]:
            raise ValueError(f"page {page} out of range "
                             f"[1, {self.shard_pages[shard]}]")
        if page in self._free_page_set[shard]:
            raise ValueError(f"double free of page {page}")
        self._free_pages[shard].append(page)
        self._free_page_set[shard].add(page)

    def commit_pages(self, slot: int, n_total: int):
        """Reserve a session's worst-case page count."""
        self._committed[slot] = max(int(n_total), int(self.pages_used[slot]))

    def alloc_pages(self, slot: int, n_rows: int):
        """Ensure pages covering logical rows ``0..n_rows-1`` are allocated
        to the slot (idempotent; growth draws from the free list of the
        slot's shard)."""
        need = -(-max(int(n_rows), 1) // self.page_len)
        have = int(self.pages_used[slot])
        if need <= have:
            return
        free = self._free_pages[self._shard(slot)]
        if need - have > len(free):
            raise RuntimeError(
                f"page arena exhausted: slot {slot} needs {need - have} more "
                f"pages, {len(free)} free")
        for i in range(have, need):
            page = free.pop()
            self._free_page_set[self._shard(slot)].discard(page)
            self.block_np[slot, i] = page
        self.pages_used[slot] = need
        self._committed[slot] = max(int(self._committed[slot]), need)
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pages_in_use)

    def table_width(self) -> int:
        """Pow2 bucket (>= 1, <= n_pages) covering every slot's allocated
        pages — the decode cost tracks the longest LIVE sequence."""
        hi = max(int(self.pages_used.max()), 1)
        b = 1
        while b < hi:
            b <<= 1
        return min(b, self.n_pages)

    def block_table(self) -> torch.Tensor:
        """Device copy of the block table at the current bucketed width
        (the host-side ``block_np`` stays authoritative); on a mesh the
        rows of slots this rank does not hold point at its scratch page."""
        w = self.table_width()
        return torch.from_numpy(
            self.local_table(range(self.n_slots), w)).to(self.device)

    def local_table(self, slots, width: int) -> np.ndarray:
        """[len(slots), width] block-table rows for a batch over ``slots``:
        each held slot's pages, zeros (the scratch page) for the rest."""
        bt = np.zeros((len(slots), width), np.int32)
        which, _ = self.rows.local(slots)
        for i in which:
            bt[i] = self.block_np[slots[i], :width]
        return bt

    def _table(self, rows) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(rows, np.int64)).to(
            self.device)

    def _one_device(self, what: str):
        if self.mesh is not None:
            raise NotImplementedError(
                f"PagedPool.{what} is the one-device dense row I/O; on a "
                f"serving mesh sessions move by pages (read_pages / "
                f"write_pages)")

    # -- row/page I/O ---------------------------------------------------------
    def write_rows(self, batch_states, slots, positions):
        """Block-table-aware scatter: install dense logical-row blocks
        ``[L, n, R, ...]`` into each slot's pages, allocating on demand for
        the given positions — ``write_rows(read_rows(s), s, pos)`` is
        bit-exact over every allocated page. One device only (a mesh's
        pools move sessions by pages: ``read_pages`` / ``write_pages``)."""
        self._one_device("write_rows")
        R = T.tree_leaves(batch_states)[0].shape[2]
        nb = R // self.page_len
        for s, p in zip(slots, positions):
            if -(-max(int(p), 1) // self.page_len) > nb:
                raise ValueError(
                    f"{R} rows cannot cover position {p} at page_len "
                    f"{self.page_len}")
            self.alloc_pages(s, max(int(p), 1))
            self.positions[s] = int(p)
        # (row, chunk) pairs inside each slot's allocation, in order; the
        # rest would point at the scratch page and are dropped
        rows, chunks, pages = [], [], []
        for i, s in enumerate(slots):
            for j in range(min(int(self.pages_used[s]), nb)):
                rows.append(i)
                chunks.append(j)
                pages.append(int(self.block_np[s, j]))
        if not pages:
            return
        ri, ci, pg = (self._table(v) for v in (rows, chunks, pages))
        for a, r in zip(T.tree_leaves(self.states),
                        T.tree_leaves(batch_states)):
            rc = r.reshape(r.shape[:2] + (nb, self.page_len) + r.shape[3:])
            a.index_copy_(1, pg, rc[:, ri, ci].to(a.dtype))

    def read_rows(self, slots):
        """The gather inverse of :meth:`write_rows`: each slot's logical
        rows in order, ``[L, n, table_width() * page_len, ...]`` per leaf,
        with unallocated chunks zeroed. One device only."""
        self._one_device("read_rows")
        sl = np.asarray(slots, np.int64)
        nb = self.table_width()
        bt = self._table(self.block_np[sl][:, :nb])
        keep = (np.arange(nb)[None, :] < self.pages_used[sl][:, None])
        keep = torch.from_numpy(keep).to(self.device)

        def take(a):
            g = a[:, bt]                              # [L, n, nb, plen, *]
            m = keep.reshape((1,) + keep.shape + (1,) * (g.ndim - 3))
            g = torch.where(m, g, torch.zeros((), dtype=g.dtype,
                                              device=g.device))
            return g.reshape(g.shape[:2] + (nb * g.shape[3],) + g.shape[4:])

        return T.tree_map(take, self.states)

    def read_pages(self, slot: int):
        """A slot's ALLOCATED pages in block-table order — ``[L, nbu, plen,
        ...]`` per leaf, the migration payload (pages only, no dense
        expansion, no scratch rows). On a mesh: every KV head, on every
        rank of the scope, gathered from the slot's holders (a
        collective)."""
        nbu = max(int(self.pages_used[slot]), 1)
        if self.mesh is None:
            return gather_rows(self.states,
                               self._table(self.block_np[slot, :nbu]), 1)
        full = T.tree_map(lambda a: torch.empty(
            (a.shape[0], nbu) + a.shape[2:], dtype=a.dtype, device="meta"),
            T.init_decode_state(self.cfg, 1, self.page_len, device="meta"))
        mine = self.rows.holds and bool(self.rows.local([slot])[1])
        local = (gather_rows(self.states,
                             self._table(self.block_np[slot, :nbu]), 1)
                 if mine else None)
        return sharding.unshard_state(local, self.mesh, self.cfg, full,
                                      mine)

    def write_pages(self, slot: int, blocks, position: int):
        """Install a migrated-in session's page block (the exact
        :meth:`read_pages` layout, every KV head) into freshly allocated
        local pages."""
        nbu = T.tree_leaves(blocks)[0].shape[1]
        self.alloc_pages(slot, nbu * self.page_len)
        self.positions[slot] = int(position)
        if not self.rows.local([slot])[1]:
            return
        if self.mesh is not None:
            blocks = sharding.shard_state(blocks, self.mesh, self.cfg)
        scatter_rows(self.states, blocks,
                     self._table(self.block_np[slot, :nbu]), 1)


class ContinuousBatchingEngine:
    """Split-inference engine with per-request dynamic bottleneck modes on
    the paged or the dense pool. ``orchestrator`` is shared (mode
    calibration is global) but tracks one link per request id;
    ``default_channel`` serves requests that arrive without their own
    ``Channel``. The pool lives on the device of ``params``; the engine
    runs a prepared view of them (``T.prepare_params``), which shares
    every weight tensor with ``params`` — N engines over one model cost N
    pools, not N models. Params without a bottleneck bank run the
    bank-free steps (raw boundary, mode 0)."""

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 8,
                 cache_len: int = 128,
                 orchestrator: Optional[Orchestrator] = None,
                 controller: Optional[ModeController] = None,
                 freeze_modes: bool = False,
                 default_channel: Optional[Channel] = None,
                 max_pending: int = 64,
                 host_loop: bool = False,
                 max_window: int = 16,
                 paged: Optional[bool] = None,
                 page_len: int = 8,
                 n_pages: Optional[int] = None,
                 mesh=None,
                 fused_tail: bool = True,
                 telemetry: Optional[Telemetry] = None):
        if controller is not None:
            if freeze_modes:
                raise ValueError("controller and freeze_modes are mutually "
                                 "exclusive mode policies")
            if orchestrator is not None and orchestrator is not controller.orch:
                raise ValueError("pass either the controller (which owns its "
                                 "orchestrator) or an orchestrator, not both")
            orchestrator = controller.orch
        bank = params.get("bneck_modes") or ()
        if controller is not None and not len(bank):
            raise ValueError("adaptive mode control needs a bottleneck mode "
                             "bank in params (init_split_params)")
        #: serving mesh (``models.sharding.serving_mesh``) or None
        self.mesh = mesh
        self.cfg = cfg
        #: the config the rank's model runs (its heads and d_ff over mp)
        self.run_cfg = cfg
        self.plan = None
        self.device = params["embed"]["table"].device
        member = mesh is None or mesh.member
        if mesh is not None:
            self.run_cfg = mesh.local_cfg(cfg)
            self.plan = mesh.rank_plan(cfg)
            self.device = mesh.device
            if member:
                params = T.tree_map(lambda a: a.to(self.device),
                                    sharding.shard_params(params, mesh,
                                                          cfg=cfg))
        #: the engine runs the split steps (False: the bank-free ones)
        self.banked = bool(len(bank))
        # a rank off the engine group (a cluster's other replicas) keeps
        # only the host state: no weights, no pool tensors
        self.params = (T.prepare_params(params, self.run_cfg) if member
                       else None)
        self.orch = orchestrator
        self.controller = controller
        self.freeze_modes = freeze_modes
        self.default_channel = default_channel
        # homogeneous full-attention archs page their KV by default;
        # windowed / recurrent archs keep the dense pool — their decode
        # state is bounded by construction and has nothing to page
        paged_ok = T.full_attention_arch(cfg) and cfg.homogeneous
        self.paged = paged_ok if paged is None else bool(paged)
        if self.paged and not paged_ok:
            raise ValueError(
                "paged=True needs a homogeneous full-attention arch; "
                "windowed/recurrent decode state is bounded by construction")
        self.pool = (PagedPool(cfg, n_slots, cache_len, page_len=page_len,
                               n_pages=n_pages, device=self.device,
                               mesh=mesh)
                     if self.paged
                     else SlotPool(cfg, n_slots, cache_len,
                                   device=self.device, mesh=mesh))
        self.queue = RequestQueue(max_pending)
        self.active: Dict[int, Session] = {}          # slot -> session
        self.finished: List[Session] = []
        self.tick = 0
        self.mode_mix_ticks = 0       # decode ticks with >= 2 distinct modes
        self.decode_ticks = 0
        self.decoded_slot_ticks = 0   # sum over decode ticks of live slots
        self.prefill_calls = 0        # batched-prefill dispatches
        self.prefill_tokens = 0       # true prompt tokens prefilled
        self.prefill_padded_tokens = 0  # incl. bucket/batch padding
        self.requests_over_capacity = 0  # rejected: prompt can't fit cache
        self.requests_truncated = 0   # max_new_tokens clipped to capacity
        self.requests_parked = 0      # deferred at least once: arena pressure
        self._parked_rids: set = set()
        # full-attention archs must fit prompt + generation in the cache —
        # the whole arena when paged, the per-slot cache_len when dense;
        # windowed / recurrent archs are bounded-state by construction
        self.max_context: Optional[int] = (
            self.pool.capacity if self.paged
            else cache_len if T.full_attention_arch(cfg) else None)
        #: the stacked mode bank, or None: the bank-free steps
        self.stacked_bank = (bottleneck.bank_stack(
            self.params["bneck_modes"], cfg.split)
            if self.banked and member else None)
        self._tok_shape = ((n_slots, cfg.n_codebooks, 1)
                           if T.multi_codebook(cfg) else (n_slots, 1))
        self.fused_tail = bool(fused_tail)
        self.host_loop = host_loop
        self.max_window = max(int(max_window), 1)
        # device loop: tokens and positions stay on the device; the host
        # only receives small int32 token blocks, one window late
        if host_loop:
            self.cur_tokens = np.zeros(self._tok_shape, np.int32)
        else:
            self.cur_tokens = torch.zeros(self._tok_shape, dtype=torch.int32,
                                          device=self.device)
        self._positions = torch.zeros(n_slots, dtype=torch.int32,
                                      device=self.device)
        # the window's other static buffers (every window body reads and
        # writes only these, in place): the mode rows of its ticks, one
        # block table a width bucket (``_table_buf``) and its tokens
        i32 = dict(dtype=torch.int32, device=self.device)
        self._modes_buf = torch.zeros((self.max_window, n_slots), **i32)
        self._tables: Dict[int, torch.Tensor] = {}
        self._toks_out = torch.zeros((self.max_window,) + self._tok_shape,
                                     **i32)
        self._staging = [
            _Staging(self.max_window, n_slots, self._tok_shape,
                     n_slots * self.pool.n_pages if self.paged else 0,
                     torch.device(self.device))
            for _ in range(2)] if not host_loop else []
        self._windows = 0             # windows dispatched (staging parity)
        #: the window graphs: one device and the fused tail (the serving
        #: mesh's collectives and the unfused oracle chain stay eager)
        self.graphs = StepGraphs(self.device)
        self._graphed = mesh is None and self.fused_tail
        #: (snapshot of (slot, session) pairs, [K, B, 1] host tokens, K,
        #: dispatch time, telemetry block or None, the event after which
        #: the host tokens are there or None) of the most recently
        #: dispatched window, read one window later
        self._inflight: Optional[tuple] = None
        self._mode_pb: Dict[int, int] = {}   # per-mode wire bytes memo
        #: not-yet-arrived requests as a min-heap on (arrival_tick, seq)
        self._pending: List[Tuple[int, int, Request]] = []
        self._pending_seq = 0
        # telemetry is optional and additive: None runs the plain engine; a
        # Telemetry object turns on the host-side observations below
        self._tel = telemetry
        #: host-side fold of the window telemetry blocks (wire bytes,
        #: decoded slot-ticks, per-mode tick histogram) — the oracle the
        #: telemetry tests cross-check against host wire accounting
        self.device_tel = {"wire_bytes": 0, "slot_ticks": 0,
                           "mode_ticks": np.zeros(0, np.int64)}
        self._pb_table = None
        if self._tel is not None:
            n_modes = cfg.split.n_modes if self.banked else 1
            self.device_tel["mode_ticks"] = np.zeros(n_modes, np.int64)
            self._pb_table = np.asarray(
                [self._payload_bytes(m) for m in range(n_modes)], np.int64)
            if self.controller is not None:
                tel = self._tel
                self.controller.on_escalate = (
                    lambda rid, tick, frm, to: (
                        tel.inc("engine.mode_escalations"),
                        tel.instant("mode_escalate", rid=rid, tick=tick,
                                    cat="mode", frm=frm, to=to)))

    # -- submission -----------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request for its arrival tick. Returns False if the
        admission queue rejected it (back-pressure)."""
        req.t_submit = _now()
        if req.arrival_tick > self.tick:
            heapq.heappush(self._pending,
                           (req.arrival_tick, self._pending_seq, req))
            self._pending_seq += 1
            return True
        return self.queue.submit(req)

    def _deliver_arrivals(self):
        while self._pending and self._pending[0][0] <= self.tick:
            r = heapq.heappop(self._pending)[2]
            r.t_submit = _now()
            self.queue.submit(r)

    # -- admission ------------------------------------------------------------
    def _admit(self):
        """Pop admissible requests into free slots, then prefill every new
        prompt in one batched forward per length bucket (loops: a budget-1
        session completes inside its own prefill and frees its slot)."""
        while self.pool.n_free and len(self.queue):
            admits = self._collect_admits()
            if self.mesh is not None:
                # the leader's admissions (slot, mode, budget) are the ones
                # every rank prefills; a rank that admitted others raises
                ctl = np.zeros(1 + 3 * self.pool.n_slots, np.int64)
                ctl[0] = len(admits)
                for i, (_, slot, mode, budget, _) in enumerate(admits):
                    ctl[1 + 3 * i:4 + 3 * i] = (slot, mode, budget)
                self.mesh.agree(ctl, "admission")
            if not admits:            # everything popped was over capacity
                break
            for blen, group in sorted(_group_by_bucket(admits).items()):
                self._prefill_group(blen, group)

    def _collect_admits(self) -> List[tuple]:
        admits: List[tuple] = []      # (req, slot, mode, budget, capacity)
        while self.pool.n_free and len(self.queue):
            req = self.queue.peek()
            budget = req.max_new_tokens
            if self.max_context is not None:
                if req.prompt_len > self.max_context:
                    self.queue.pop()  # the prompt alone cannot fit: reject
                    self.requests_over_capacity += 1
                    if self._tel is not None:
                        self._tel.instant("reject_over_capacity",
                                          cat="admission", rid=req.rid,
                                          prompt_len=req.prompt_len)
                    continue
                # the first generated token is the prefill argmax (no cache
                # write), so b <= max_context - prompt_len + 1 never wraps
                budget = min(budget, self.max_context - req.prompt_len + 1)
            worst = 0
            if self.paged:
                worst = -(-(req.prompt_len + budget - 1)
                          // self.pool.page_len)
                if worst > self.pool.pages_available:
                    # arena backpressure: PARK at the queue head (FIFO)
                    if req.rid not in self._parked_rids:
                        self._parked_rids.add(req.rid)
                        self.requests_parked += 1
                        if self._tel is not None:
                            self._tel.instant(
                                "park_arena", cat="admission", rid=req.rid,
                                pages_needed=worst,
                                pages_available=self.pool.pages_available)
                    break
            self.queue.pop()
            req.t_admit = _now()
            if budget < req.max_new_tokens:
                self.requests_truncated += 1
            slot = self.pool.acquire()
            if self.paged:
                self.pool.commit_pages(slot, worst)
                self.pool.alloc_pages(slot, req.prompt_len)
            if req.channel is None:
                req.channel = self.default_channel
            mode, cap = 0, None
            if self.orch is not None:
                if self.controller is not None:
                    if req.channel is not None:
                        cap = req.channel.step()
                    mode = self.controller.admit(req.rid, req.requirement,
                                                 cap, self.tick)
                else:
                    self.orch.register(req.rid, req.requirement)
                    if req.channel is not None:
                        cap = req.channel.step()
                        self.orch.observe_capacity(cap, rid=req.rid)
                    if self.banked:
                        mode = self.orch.choose_mode(rid=req.rid)
            admits.append((req, slot, mode, budget, cap))
        return admits

    def _prefill_group(self, blen: int, group: List[tuple]):
        """ONE batched prefill for every request in a bucket: prompts
        right-padded to ``blen``, batch padded to a power of two, each
        row's boundary through its admission-chosen mode. Paged: K/V
        scatter straight into the admit-time-allocated arena pages. Dense:
        the bucket prefills a fresh state, whose rows are then written into
        the slots in one scatter."""
        n = len(group)
        t_pre = _now() if self._tel is not None else 0.0
        bp = _bucket_len(n, lo=1)          # pow2 batch
        toks = np.zeros((bp,) + self._tok_shape[1:-1] + (blen,), np.int32)
        lens = np.ones(bp, np.int32)       # pad rows: harmless length-1 rows
        modes = np.zeros(bp, np.int32)
        for i, (req, _, mode, _, _) in enumerate(group):
            toks[i, ..., :req.prompt_len] = req.prompt
            lens[i] = req.prompt_len
            modes[i] = mode
        dev = self.device
        slots = [a[1] for a in group]
        new_states = None
        if self.params is not None:
            first_dev, new_states = self._prefill_rows(toks, lens, modes,
                                                       slots, blen, bp)
        else:                              # off the engine group
            first_dev = torch.zeros((bp,) + self._tok_shape[1:],
                                    dtype=torch.int32, device=dev)
        if self.mesh is not None:
            # every rank of the group computed these; all take the leader's
            first_dev = self.mesh.share(first_dev)
        self.prefill_calls += 1
        self.prefill_tokens += int(lens[:n].sum())
        self.prefill_padded_tokens += bp * blen
        first = first_dev.cpu().numpy()    # once per admitted bucket
        now = _now()
        if self._tel is not None:
            self._tel.complete("prefill", t_pre, now - t_pre, cat="window",
                               rows=n, bucket=blen)
            self._tel.observe("engine.prefill_s", now - t_pre)
        plens = [a[0].prompt_len for a in group]
        if self.paged:
            # the prefill already wrote the arena through the block tables
            for s, p in zip(slots, plens):
                self.pool.positions[s] = p
        else:
            # ONE scatter moves every admitted row into its pool slot
            self.pool.write_rows(new_states, slots, plens)
        if not self.host_loop:
            _admit_meta(self._positions, self.cur_tokens,
                        torch.tensor(slots, dtype=torch.long, device=dev),
                        torch.tensor(plens, dtype=torch.int32, device=dev),
                        first_dev)
        for i, (req, slot, mode, budget, cap) in enumerate(group):
            tok = first[i]
            if self.host_loop:
                self.cur_tokens[slot] = tok
            sess = Session(request=req, slot=slot, admitted_tick=self.tick,
                           gen_budget=budget, admission_mode=mode,
                           mode_trace=[(self.tick, mode)])
            sess.pos = req.prompt_len
            # the prefill's argmax IS the first generated token
            sess.tokens.append(int(tok.reshape(-1)[0]))
            sess.ttft_s = now - req.t_submit if req.t_submit else 0.0
            if self._tel is not None:
                if req.t_submit:
                    self._tel.observe("engine.ttft_s", sess.ttft_s)
                if req.t_admit:
                    self._tel.observe("engine.admit_to_first_token_s",
                                      now - req.t_admit)
                self._tel.instant("admit", cat="admission", rid=req.rid,
                                  slot=slot, mode=mode, t=now)
            # the prompt's boundary activations cross the uplink once, in
            # the admission-chosen mode
            pb = bottleneck.mode_payload_bytes(self.cfg, 1, req.prompt_len,
                                               mode)
            sess.prefill_wire_bytes = pb
            sess.wire_bytes += pb
            if self.orch is not None:
                link = self.orch.register(req.rid)
                sess.transfer_s += tx_seconds(
                    pb, cap if cap is not None else link.capacity_ema)
            if sess.done:                # budget == 1: already complete
                sess.finished_tick = self.tick
                self._release_links(sess)
                self.pool.release(slot)
                self.finished.append(sess)
            else:
                self.active[slot] = sess

    def _prefill_rows(self, toks, lens, modes, slots, blen: int, bp: int):
        """The bucket's one batched prefill on this rank (every row: a mesh
        runs admission replicated over dp). Paged: K/V scatter through the
        block tables of the slots this rank holds (other rows: the scratch
        page). Returns (first tokens [bp, 1] ([bp, K, 1] audio) int32, the
        dense pool's fresh batch state or None)."""
        dev = self.device
        bt = None
        if self.paged:
            nb_p = max(-(-blen // self.pool.page_len), 1)
            bt_np = np.zeros((bp, nb_p), np.int32)  # pad rows -> scratch page
            bt_np[:len(slots)] = self.pool.local_table(slots, nb_p)
            bt = torch.from_numpy(bt_np).to(dev)
            states = self.pool.states
        else:
            states = T.init_decode_state(self.cfg, bp, self.pool.cache_len,
                                         device=dev, mp=_mp(self.mesh))
        toks_dev = torch.from_numpy(toks).to(dev)
        lens_dev = torch.from_numpy(lens).to(dev)
        if self.banked:
            logits, new_states = SP.split_prefill_mixed(
                self.params, self.stacked_bank, toks_dev, states,
                self.run_cfg, torch.from_numpy(modes).to(dev),
                lengths=lens_dev, block_table=bt, mesh=self.mesh,
                plan=self.plan)
        else:                              # no bank: the raw boundary
            logits, new_states = T.prefill(self.params, toks_dev,
                                           self.run_cfg, states,
                                           lengths=lens_dev, block_table=bt,
                                           plan=self.plan)
        # [bp, 1] ([bp, K, 1] audio)
        return (torch.argmax(logits, dim=-1).to(torch.int32),
                None if self.paged else new_states)

    def _release_links(self, sess: Session):
        """Drop a retiring session's orchestrator/controller state."""
        if self.controller is not None:
            ctl = self.controller.finish(sess.request.rid)
            if ctl is not None:
                sess.escalations = ctl.escalations
        elif self.orch is not None:
            self.orch.release(sess.request.rid)

    # -- decode ---------------------------------------------------------------
    def _payload_bytes(self, mode: int) -> int:
        """Per-token wire bytes for ``mode`` (memoized)."""
        pb = self._mode_pb.get(mode)
        if pb is None:
            pb = self._mode_pb[mode] = bottleneck.mode_payload_bytes(
                self.cfg, 1, 1, mode)
        return pb

    def _choose_modes(self, tick: Optional[int] = None,
                      items=None) -> np.ndarray:
        """Per-slot mode selection for ONE decode tick. Every live session's
        channel advances one tick regardless of policy; the policy decides
        what to do with the observation (adaptive controller, frozen
        admission mode, or the orchestrator's per-tick loop). Also accounts
        wire bytes / transfer time, mode-switch traces and deadline
        misses."""
        tick = self.tick if tick is None else tick
        modes = np.zeros(self.pool.n_slots, np.int32)
        if items is None:                          # deterministic slot order
            items = sorted(self.active.items())
        caps = [sess.request.channel.step()
                if self.orch is not None and sess.request.channel is not None
                else None
                for _, sess in items]
        chosen = None
        if self.controller is not None and items:
            chosen = self.controller.step_modes(
                [sess.request.rid for _, sess in items], caps, tick)
        for i, (slot, sess) in enumerate(items):
            mode = 0
            if self.orch is not None:
                rid = sess.request.rid
                cap = caps[i]
                if chosen is not None:
                    mode = int(chosen[i])
                else:
                    if cap is not None:
                        self.orch.observe_capacity(cap, rid=rid)
                    # no bank: only the raw boundary can cross, so the
                    # tick is accounted on mode 0
                    if self.banked:
                        mode = (sess.admission_mode if self.freeze_modes
                                else self.orch.choose_mode(rid=rid))
                pb = self._payload_bytes(mode)
                link = self.orch.register(rid)
                tx = tx_seconds(pb, cap if cap is not None
                                else link.capacity_ema)
                sess.account(mode, pb, tx)
                # deadline misses only count against an observed link
                if link.ticks > 0 and \
                        tx > self.orch.requirement_for(rid).latency_budget_s:
                    sess.deadline_misses += 1
            else:
                sess.account(0, self._payload_bytes(0), 0.0)
            if sess.mode_trace and sess.mode_trace[-1][1] != mode:
                if self._tel is not None:
                    self._tel.inc("engine.mode_switches")
                    self._tel.instant("mode_switch", cat="mode",
                                      rid=sess.request.rid, tick=tick,
                                      frm=sess.mode_trace[-1][1], to=mode)
                sess.mode_trace.append((tick, mode))
            modes[slot] = mode
        return modes

    def step(self) -> bool:
        """One engine tick (host loop) or one decode window (device loop).
        Returns False when there is nothing left to do."""
        return self._step_host() if self.host_loop else self._step_device()

    def _step_host(self) -> bool:
        """Synchronous tick: one mixed decode step, logits + argmax read
        back before the next tick (the equivalence oracle)."""
        self._deliver_arrivals()
        self._admit()
        if not self.active:
            if self._pending:          # idle until the next arrival
                self.tick = self._pending[0][0]
                return True
            return False
        t0 = _now() if self._tel is not None else 0.0
        modes = self._choose_modes()
        if self.mesh is not None:
            self._agree_window(modes[None])
        bt = None
        if self.paged:
            for slot in self.active:   # this tick writes row pos per slot
                self.pool.alloc_pages(slot,
                                      int(self.pool.positions[slot]) + 1)
            bt = self.pool.block_table()
        dev = self.device
        nxt = None
        if self.params is not None:
            logits = self._decode(
                torch.from_numpy(self.cur_tokens.copy()).to(dev),
                torch.from_numpy(self.pool.positions.copy()).to(dev),
                torch.from_numpy(modes).to(dev), bt, False)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if self.mesh is not None:
            nxt = self._exchange(None if nxt is None else nxt[None])[0]
        nxt = nxt.cpu().numpy()

        if self._tel is not None:
            # one synchronous host tick == one token per live slot
            self._tel.observe("engine.intertoken_s", _now() - t0,
                              len(self.active))
            self._tel.set("engine.queue_depth", len(self.queue))
            self._tel.set("engine.slot_occupancy",
                          len(self.active) / self.pool.n_slots)
            self._tel.inc("engine.decode_wire_bytes",
                          sum(self._payload_bytes(int(modes[s]))
                              for s in self.active))
            self._tel.inc("engine.decode_tokens", len(self.active))
            if self.paged:
                self._tel.set("engine.page_occupancy",
                              self.pool.pages_in_use
                              / max(self.pool.n_pages, 1))

        self.decode_ticks += 1
        self.decoded_slot_ticks += len(self.active)
        if len({int(m) for s, m in enumerate(modes) if s in self.active}) > 1:
            self.mode_mix_ticks += 1
        for slot in list(self.active):
            sess = self.active[slot]
            tok = nxt[slot]
            sess.tokens.append(int(tok.reshape(-1)[0]))
            self.cur_tokens[slot] = tok
            self.pool.positions[slot] += 1
            sess.pos += 1
            if sess.done:
                sess.finished_tick = self.tick
                self._release_links(sess)
                del self.active[slot]
                self.pool.release(slot)
                self.finished.append(sess)
        self.tick += 1
        return True

    def _window_len(self) -> int:
        """Ticks the next window may cover: bounded by the earliest session
        completion, the next pending arrival and ``max_window``, floored to
        a power of two."""
        rem = min((sess.gen_budget or sess.request.max_new_tokens)
                  - (sess.pos - sess.request.prompt_len + 1)
                  for sess in self.active.values())
        k = max(rem, 1)
        if self._pending:
            k = min(k, max(self._pending[0][0] - self.tick, 1))
        k = min(k, self.max_window)
        return 1 << (k.bit_length() - 1)

    def _step_device(self) -> bool:
        """One decode window of K ticks with a one-window-lagged host read.
        Slot lifecycle stays tick-exact with the host loop; token values
        land one window late."""
        self._deliver_arrivals()
        self._admit()
        if not self.active:
            self._materialize_inflight()
            if self._pending:          # idle until the next arrival
                self.tick = self._pending[0][0]
                return True
            return False

        t0 = _now() if self._tel is not None else 0.0
        k = self._window_len()
        width = 0
        if self.paged:
            # every row the window writes (pos..pos+k-1 per live slot) gets
            # its page before dispatch; the table ships at its width bucket
            for slot in self.active:
                self.pool.alloc_pages(slot,
                                      int(self.pool.positions[slot]) + k)
            width = self.pool.table_width()
        snapshot = sorted(self.active.items())
        modes_k = np.stack([self._choose_modes(self.tick + i, items=snapshot)
                            for i in range(k)])
        if self.mesh is not None:
            self._agree_window(modes_k)
        prev = self._inflight
        toks_k, event = self._run_window(modes_k, width)
        tel_blk = None
        if self._tel is not None:
            # the live set is frozen per window: its mask and the window's
            # mode matrix give the telemetry block, which is folded in with
            # the window's tokens, one window late
            active = np.zeros(self.pool.n_slots, np.int64)
            for slot, _ in snapshot:
                active[slot] = 1
            tel_blk = self._tel_block(modes_k, active)
        # snapshot BEFORE retirement: these sessions each emit one token
        # per window tick, whose values land at the next materialization
        self._inflight = (snapshot, toks_k, k,
                          _now() if self._tel is not None else 0.0, tel_blk,
                          event)
        if self._tel is not None:
            self._tel.complete("window_dispatch", t0, _now() - t0,
                               cat="window", k=k, live=len(snapshot),
                               tick=self.tick)
            self._tel.observe("engine.window_dispatch_s", _now() - t0)
            self._tel.set("engine.queue_depth", len(self.queue))
            self._tel.set("engine.slot_occupancy",
                          len(snapshot) / self.pool.n_slots)
            if self.paged:
                self._tel.set("engine.page_occupancy",
                              self.pool.pages_in_use
                              / max(self.pool.n_pages, 1))

        self.decode_ticks += k
        self.decoded_slot_ticks += k * len(snapshot)
        active_slots = set(self.active)
        for i in range(k):
            if len({int(m) for s, m in enumerate(modes_k[i])
                    if s in active_slots}) > 1:
                self.mode_mix_ticks += 1
        # budget-based retirement at dispatch time (sessions can only
        # complete at the window's last tick)
        for slot, sess in snapshot:
            sess.pos += k
            self.pool.positions[slot] += k
            emitted = sess.pos - sess.request.prompt_len + 1  # incl. prefill
            budget = sess.gen_budget or sess.request.max_new_tokens
            if emitted >= budget:
                sess.finished_tick = self.tick + k - 1
                self._release_links(sess)
                del self.active[slot]
                self.pool.release(slot)
        # read the PREVIOUS window's tokens while the device runs this one
        if prev is not None:
            self._materialize(prev)
        self.tick += k
        return True

    def _decode(self, tok, positions, modes, bt, return_tokens: bool):
        """One decode step over the pool (in place): the mixed-mode split
        step, or without a bank the unsplit model's. Returns its logits
        or, with ``return_tokens``, the decode tail's tokens."""
        if not self.banked:
            out, _ = T.decode_step(self.params, tok, self.pool.states,
                                   positions, self.run_cfg,
                                   return_tokens=return_tokens,
                                   block_table=bt, plan=self.plan)
        else:
            out, _ = SP.split_decode_step_mixed(
                self.params, self.stacked_bank, tok, self.pool.states,
                positions, self.run_cfg, modes, bt,
                return_tokens=return_tokens, mesh=self.mesh, plan=self.plan)
        return out

    # -- the serving mesh -----------------------------------------------------
    def _agree_window(self, modes_k: np.ndarray):
        """The leader's window (its length and every tick's mode vector) is
        the one every rank decodes: one broadcast a window or host tick; a
        rank whose own schedule differs raises."""
        n = self.pool.n_slots
        ctl = np.zeros(1 + self.max_window * n, np.int64)
        ctl[0] = modes_k.shape[0]
        ctl[1:1 + modes_k.size] = modes_k.reshape(-1)
        self.mesh.agree(ctl, "decode window")

    def _exchange(self, toks, k: int = 1) -> torch.Tensor:
        """Every slot's tokens [k, n_slots, ...] on every rank of the scope,
        each slot's from the rank that holds it: ``toks`` the rows this
        rank decoded (None off the engine group), through
        ``mesh.exchange``."""
        r = self.pool.rows
        local = (toks[:, r.lo:r.hi] if toks is not None else
                 torch.zeros((k, 0) + self._tok_shape[1:],
                             dtype=torch.int32, device=self.device))
        return self.mesh.exchange(local, self.pool.n_slots)

    def _table_buf(self, width: int) -> torch.Tensor:
        """The static device block table of a width bucket."""
        if width not in self._tables:
            self._tables[width] = torch.zeros(
                (self.pool.n_slots, width), dtype=torch.int32,
                device=self.device)
        return self._tables[width]

    def _window_body(self, k: int, bt):
        """The window's K ticks over the static buffers: tick i decodes
        ``cur_tokens`` (tick 0) or tick i-1's token at ``_positions`` on
        mode row i, writes its token (the fused tail's, or with
        ``fused_tail=False`` the argmax of its logits) to row i of
        ``_toks_out`` and advances the positions, all in place; the last
        token becomes ``cur_tokens``. The counterpart of the reference's
        ``_window_scan_body`` under ``lax.scan``."""
        def body():
            tok = self.cur_tokens
            for i in range(k):
                out = self._decode(tok, self._positions, self._modes_buf[i],
                                   bt, self.fused_tail)
                nxt = out if self.fused_tail else torch.argmax(out, dim=-1)
                tok = self._toks_out[i]
                tok.copy_(nxt.reshape(tok.shape))
                self._positions.add_(1)
            self.cur_tokens.copy_(tok)
        return body

    def _run_window(self, modes_k: np.ndarray, width: int):
        """Enqueue the window's K decode ticks: its mode rows and (paged)
        its block table copied into their static buffers, then one replay
        of the window's graph (on one CUDA device; eager ticks on a mesh,
        with ``fused_tail=False`` and on the CPU); on a serving mesh one
        token exchange then gives every rank of the scope each slot's
        tokens from the rank that holds it. The tokens are copied to
        pinned host memory behind the ticks. Returns (the window's [K, B,
        1] ([K, B, K_cb, 1] audio) int32 host tokens, there once the event
        has fired (the event None: there now))."""
        k = modes_k.shape[0]
        st = self._staging[self._windows % 2]
        self._windows += 1
        if st.event is not None:
            st.event.synchronize()    # window n - 2: read already
        if self.params is not None:
            st.modes[:k].copy_(torch.from_numpy(modes_k))
            self._modes_buf[:k].copy_(st.modes[:k], non_blocking=True)
            bt = None
            if self.paged:
                n = self.pool.n_slots
                bt = self._table_buf(width)
                host = st.table[:n * width].view(n, width)
                host.copy_(torch.from_numpy(
                    self.pool.local_table(range(n), width)))
                bt.copy_(host, non_blocking=True)
            body = self._window_body(k, bt)
            if self._graphed:
                self.graphs.run((k, width, self.fused_tail, self.banked),
                                body, steps=k)
            else:
                body()
        toks_k = self._toks_out[:k]
        if self.mesh is not None:
            # every rank takes each slot's tokens from the rank that holds
            # it (a rank off the engine group decoded nothing)
            toks_k = self._exchange(
                toks_k if self.params is not None else None, k)
            self.cur_tokens.copy_(toks_k[-1])
            if self.params is None:
                self._positions.add_(k)
        host = st.toks[:k]
        host.copy_(toks_k, non_blocking=True)
        if st.event is not None:
            st.event.record()
        return host, st.event

    def _tel_block(self, modes_k: np.ndarray, active: np.ndarray
                   ) -> np.ndarray:
        """The window's per-tick telemetry rows ``[K, 2 + M]``: ``[wire
        bytes, live slots, ticks per mode...]`` over the live mask — the
        reference's scan rows (``_window_scan_body``), with the same
        integer arithmetic on the same inputs, computed on the host."""
        n_modes = self._pb_table.shape[0]
        hist = np.zeros((modes_k.shape[0], n_modes), np.int64)
        for i, modes in enumerate(modes_k):
            np.add.at(hist[i], modes, active)
        wire = (active[None, :] * self._pb_table[modes_k]).sum(axis=1)
        live = np.full(modes_k.shape[0], int(active.sum()), np.int64)
        return np.concatenate([wire[:, None], live[:, None], hist], axis=1)

    def close(self):
        """Land any in-flight window (its tokens are read to the host).
        Idempotent; the engine stays usable."""
        self._materialize_inflight()

    def __enter__(self) -> "ContinuousBatchingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _materialize(self, inflight):
        """Copy one window's token block to the host and append it to the
        snapshot's sessions; sessions whose budget completed move to
        ``finished`` (their slots were freed at dispatch). With telemetry
        the window's block folds into ``device_tel`` and the registry
        here, one window late, like the tokens."""
        snapshot, toks_k, k, t_disp, tel_blk, event = inflight
        t_mat = _now() if self._tel is not None else 0.0
        if event is not None:
            event.synchronize()       # this window's copy, no later work
        arr = toks_k.numpy()                          # [K, B, 1]
        if tel_blk is not None:
            wire = int(tel_blk[:, 0].sum())
            slot_ticks = int(tel_blk[:, 1].sum())
            self.device_tel["wire_bytes"] += wire
            self.device_tel["slot_ticks"] += slot_ticks
            self.device_tel["mode_ticks"] += tel_blk[:, 2:].sum(axis=0)
            self._tel.inc("engine.decode_wire_bytes", wire)
            self._tel.inc("engine.decode_tokens", slot_ticks)
            # window wall clock (dispatch -> tokens on host) over k ticks
            # is the device loop's inter-token latency, weighted by the
            # tokens the window produced
            wall = _now() - t_disp
            if slot_ticks:
                self._tel.observe("engine.intertoken_s", wall / k,
                                  slot_ticks)
        for slot, sess in snapshot:
            for i in range(k):
                sess.tokens.append(int(arr[i, slot].reshape(-1)[0]))
            budget = sess.gen_budget or sess.request.max_new_tokens
            if len(sess.tokens) >= budget:
                self.finished.append(sess)
        if self._tel is not None:
            dur = _now() - t_mat
            self._tel.complete("window_materialize", t_mat, dur,
                               cat="window", k=k)
            self._tel.observe("engine.window_materialize_s", dur)

    def _materialize_inflight(self):
        if self._inflight is not None:
            prev, self._inflight = self._inflight, None
            self._materialize(prev)

    def warm(self, prompt: np.ndarray, gen: int = 2):
        """Run every path a measured run can hit — each power-of-two prefill
        batch bucket up to the slot pool and (device loop) each
        power-of-two window length up to ``max_window``, which captures
        their window graphs on one CUDA device — then zero the counters.
        ``prompt`` should have the measured run's length."""
        self._warm_buckets(prompt, gen)
        if not self.host_loop:
            w = 1
            while w <= self.max_window:
                self.run([Request(rid=-1 - i, prompt=np.asarray(prompt),
                                  max_new_tokens=w + 1)
                          for i in range(self.pool.n_slots)])
                w <<= 1
        self.reset_counters()

    def _warm_buckets(self, prompt: np.ndarray, gen: int):
        """Each power-of-two prefill batch bucket up to the slot pool, each
        followed by ``gen - 1`` decode ticks."""
        k = 1
        while True:
            n = min(k, self.pool.n_slots)
            self.run([Request(rid=-1 - i, prompt=np.asarray(prompt),
                              max_new_tokens=gen) for i in range(n)])
            if k >= self.pool.n_slots:
                break
            k <<= 1

    def reset_counters(self):
        """Zero every aggregate stat while keeping pool state and the
        orchestrator calibration."""
        self._materialize_inflight()
        self.finished.clear()
        self.tick = 0
        self.decode_ticks = self.mode_mix_ticks = 0
        self.decoded_slot_ticks = 0
        self.prefill_calls = self.prefill_tokens = 0
        self.prefill_padded_tokens = 0
        self.requests_over_capacity = self.requests_truncated = 0
        self.requests_parked = 0
        self._parked_rids.clear()
        if self.paged:
            self.pool.peak_pages_in_use = self.pool.pages_in_use
        self.queue.submitted = self.queue.rejected = 0
        self.device_tel["wire_bytes"] = self.device_tel["slot_ticks"] = 0
        self.device_tel["mode_ticks"] = np.zeros_like(
            self.device_tel["mode_ticks"])
        if self._tel is not None:
            # shared across a cluster's replicas — a reset between warm-up
            # and measurement clears everyone's warm data
            self._tel.registry.reset()

    def run(self, requests: Optional[List[Request]] = None,
            max_ticks: int = 100_000) -> List[Session]:
        """Drive the engine until every submitted request completes (or the
        tick budget runs out). Returns the finished sessions."""
        for r in requests or []:
            self.submit(r)
        for _ in range(max_ticks):
            if not self.step():
                break
        # tick-budget exhaustion: don't drop the last window's tokens
        self._materialize_inflight()
        return self.finished

    # -- aggregate stats ------------------------------------------------------
    def stats(self) -> dict:
        toks = sum(len(s.tokens) for s in self.finished)
        # the first token of every session came from its prefill
        dec_toks = sum(max(len(s.tokens) - 1, 0) for s in self.finished)
        wire = sum(s.wire_bytes for s in self.finished)
        prefill_wire = sum(s.prefill_wire_bytes for s in self.finished)
        decode_wire = wire - prefill_wire
        mix: Dict[int, int] = {}
        for s in self.finished:
            for m, c in s.mode_counts.items():
                mix[m] = mix.get(m, 0) + c
        switches = sum(max(len(s.mode_trace) - 1, 0) for s in self.finished)
        misses = sum(s.deadline_misses for s in self.finished)
        policy = ("adaptive" if self.controller is not None
                  else "frozen" if self.freeze_modes
                  else "per-tick" if self.orch is not None else "static")
        paged_stats = {}
        if self.paged:
            paged_stats = {
                "page_len": self.pool.page_len,
                "n_pages": self.pool.n_pages,
                "pages_in_use": int(self.pool.pages_in_use),
                "peak_pages_in_use": int(self.pool.peak_pages_in_use),
                "page_occupancy": (self.pool.peak_pages_in_use
                                   / max(self.pool.n_pages, 1)),
                "requests_parked": self.requests_parked,
            }
        out = {
            "mode_policy": policy,
            "paged": self.paged,
            **paged_stats,
            "mode_switches": switches,
            "mode_escalations": sum(s.escalations for s in self.finished),
            "deadline_misses": misses,
            "deadline_miss_rate": misses / max(dec_toks, 1),
            "requests_finished": len(self.finished),
            "requests_rejected": self.queue.rejected,
            "requests_over_capacity": self.requests_over_capacity,
            "requests_truncated": self.requests_truncated,
            "generated_tokens": toks,
            "decode_tokens": dec_toks,
            "wire_bytes": wire,
            "prefill_wire_bytes": prefill_wire,
            "decode_wire_bytes": decode_wire,
            "decode_wire_bytes_per_token": decode_wire / max(dec_toks, 1),
            "mode_counts": mix,
            "decode_ticks": self.decode_ticks,
            "decoded_slot_ticks": self.decoded_slot_ticks,
            "mixed_mode_ticks": self.mode_mix_ticks,
            "prefill_calls": self.prefill_calls,
            "prefill_tokens": self.prefill_tokens,
            "prefill_padded_tokens": self.prefill_padded_tokens,
            "mean_ttft_s": (float(np.mean([s.ttft_s for s in self.finished]))
                            if self.finished else 0.0),
        }
        if self._tel is not None:
            # mirror the totals into the registry so the JSON / Prometheus
            # exports agree with this dict
            self._tel.registry.ingest("engine.stats", out)
        return out
