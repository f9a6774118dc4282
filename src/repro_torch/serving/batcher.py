"""Continuous-batching split serving (mirrors the mixed-mode, fused-tail
path of ``repro.serving.batcher``).

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
   t). The window is a plain Python loop over ticks;
4. accounts wire bytes and simulated transfer latency per request and
   retires finished sessions at dispatch time.

``host_loop=True`` keeps the synchronous per-tick loop (logits + argmax
read back every tick) as the equivalence oracle; both loops decode
identical token streams. The bank-free mono steps, mesh sharding,
telemetry and migration are not ported yet and raise.
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bottleneck
from repro_torch.core import split as SP
from repro_torch.core.channel import Channel, tx_seconds
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.models import transformer as T
from repro_torch.serving.controller import ModeController
from repro_torch.serving.session import Request, RequestQueue, Session

_now = time.perf_counter


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


class SlotPool:
    """Fixed pool of decode slots with recycled dense state: per-slot
    rolling KV caches and RG-LRU carries, written in place on the device."""

    paged = False

    def __init__(self, cfg: ModelConfig, n_slots: int, cache_len: int, *,
                 device=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.device = device
        self.states = T.init_decode_state(cfg, n_slots, cache_len,
                                          device=device)
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

    def _idx(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, np.int64), device=self.device)

    def write_rows(self, batch_states, slots, positions):
        """Install rows 0..len(slots)-1 of a freshly prefilled batched state
        into the given slots (full overwrite of the previous occupant)."""
        scatter_rows(self.states, batch_states, self._idx(slots),
                     _slot_axis(self.cfg))
        for s, p in zip(slots, positions):
            self.positions[s] = p

    def read_rows(self, slots):
        """The given slots' decode state as a batched state tree, the shape
        ``write_rows`` accepts."""
        return gather_rows(self.states, self._idx(slots),
                           _slot_axis(self.cfg))


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
    satisfied."""

    def __init__(self, cfg: ModelConfig, n_slots: int, cache_len: int, *,
                 page_len: int = 8, n_pages: Optional[int] = None,
                 device=None):
        if not (T.full_attention_arch(cfg) and cfg.homogeneous):
            raise ValueError("paged pools need a homogeneous full-attention "
                             "arch")
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.page_len = page_len
        self.device = device
        per_slot = -(-cache_len // page_len)
        self.n_pages = n_pages if n_pages is not None else n_slots * per_slot
        #: arena rows — ONE session's max context (it may claim every page)
        self.capacity = self.n_pages * page_len
        self.states = T.init_decode_state(cfg, self.n_pages + 1, page_len,
                                          device=device)
        self.positions = np.zeros(n_slots, np.int32)
        self._free = list(range(n_slots - 1, -1, -1))
        self.block_np = np.zeros((n_slots, self.n_pages), np.int32)
        self.pages_used = np.zeros(n_slots, np.int32)
        self._committed = np.zeros(n_slots, np.int32)
        self._free_pages = list(range(self.n_pages, 0, -1))  # pop -> 1, 2, ..
        self._free_page_set = set(self._free_pages)
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
            self._push_free_page(int(self.block_np[slot, i]))
        self.block_np[slot, :] = 0
        self.pages_used[slot] = 0
        self._committed[slot] = 0
        self.positions[slot] = 0
        self._free.append(slot)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free_pages)

    @property
    def pages_available(self) -> int:
        """Pages a NEW admission may claim: the free list minus pages
        already committed to resident sessions but not drawn."""
        reserved = int(self._committed.sum()) - int(self.pages_used.sum())
        return len(self._free_pages) - reserved

    def _push_free_page(self, page: int):
        if not 1 <= page <= self.n_pages:
            raise ValueError(f"page {page} out of range [1, {self.n_pages}]")
        if page in self._free_page_set:
            raise ValueError(f"double free of page {page}")
        self._free_pages.append(page)
        self._free_page_set.add(page)

    def commit_pages(self, slot: int, n_total: int):
        """Reserve a session's worst-case page count."""
        self._committed[slot] = max(int(n_total), int(self.pages_used[slot]))

    def alloc_pages(self, slot: int, n_rows: int):
        """Ensure pages covering logical rows ``0..n_rows-1`` are allocated
        to the slot (idempotent; growth draws from the free list)."""
        need = -(-max(int(n_rows), 1) // self.page_len)
        have = int(self.pages_used[slot])
        if need <= have:
            return
        if need - have > len(self._free_pages):
            raise RuntimeError(
                f"page arena exhausted: slot {slot} needs {need - have} more "
                f"pages, {len(self._free_pages)} free")
        for i in range(have, need):
            page = self._free_pages.pop()
            self._free_page_set.discard(page)
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
        """Device copy of the block table at the current bucketed width (the
        host-side ``block_np`` stays authoritative)."""
        return torch.from_numpy(
            self.block_np[:, :self.table_width()].copy()).to(self.device)


class ContinuousBatchingEngine:
    """Split-inference engine with per-request dynamic bottleneck modes on
    the paged or the dense pool. ``orchestrator`` is shared (mode
    calibration is global) but tracks one link per request id;
    ``default_channel`` serves requests that arrive without their own
    ``Channel``. The pool lives on the device of ``params``."""

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
                 telemetry=None):
        if mesh is not None or telemetry is not None:
            raise NotImplementedError(
                "repro_torch serves on one device without telemetry; mesh "
                "sharding and telemetry are not ported yet")
        if controller is not None:
            if freeze_modes:
                raise ValueError("controller and freeze_modes are mutually "
                                 "exclusive mode policies")
            if orchestrator is not None and orchestrator is not controller.orch:
                raise ValueError("pass either the controller (which owns its "
                                 "orchestrator) or an orchestrator, not both")
            orchestrator = controller.orch
        bank = params.get("bneck_modes") or ()
        if not len(bank):
            raise NotImplementedError(
                "repro_torch serves the mixed-mode split path only: params "
                "need a bottleneck mode bank (init_split_params)")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"]["table"].device
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
                               n_pages=n_pages, device=self.device)
                     if self.paged
                     else SlotPool(cfg, n_slots, cache_len,
                                   device=self.device))
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
        self.stacked_bank = bottleneck.bank_stack(bank, cfg.split)
        self.host_loop = host_loop
        self.max_window = max(int(max_window), 1)
        # device loop: tokens and positions stay on the device; the host
        # only receives small int32 token blocks, one window late
        if host_loop:
            self.cur_tokens = np.zeros((n_slots, 1), np.int32)
        else:
            self.cur_tokens = torch.zeros((n_slots, 1), dtype=torch.int32,
                                          device=self.device)
        self._positions = torch.zeros(n_slots, dtype=torch.int32,
                                      device=self.device)
        #: (snapshot of (slot, session) pairs, [K, B, 1] device tokens, K)
        #: of the most recently dispatched window, read one window later
        self._inflight: Optional[tuple] = None
        self._mode_pb: Dict[int, int] = {}   # per-mode wire bytes memo
        #: not-yet-arrived requests as a min-heap on (arrival_tick, seq)
        self._pending: List[Tuple[int, int, Request]] = []
        self._pending_seq = 0

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
        bp = _bucket_len(n, lo=1)          # pow2 batch
        toks = np.zeros((bp, blen), np.int32)
        lens = np.ones(bp, np.int32)       # pad rows: harmless length-1 rows
        modes = np.zeros(bp, np.int32)
        for i, (req, _, mode, _, _) in enumerate(group):
            toks[i, :req.prompt_len] = req.prompt
            lens[i] = req.prompt_len
            modes[i] = mode
        dev = self.device
        bt = None
        if self.paged:
            nb_p = max(-(-blen // self.pool.page_len), 1)
            bt_np = np.zeros((bp, nb_p), np.int32)  # pad rows -> scratch page
            for i, (_, slot, _, _, _) in enumerate(group):
                bt_np[i] = self.pool.block_np[slot, :nb_p]
            bt = torch.from_numpy(bt_np).to(dev)
            states = self.pool.states
        else:
            states = T.init_decode_state(self.cfg, bp, self.pool.cache_len,
                                         device=dev)
        logits, new_states = SP.split_prefill_mixed(
            self.params, self.stacked_bank, torch.from_numpy(toks).to(dev),
            states, self.cfg, torch.from_numpy(modes).to(dev),
            lengths=torch.from_numpy(lens).to(dev), block_table=bt)
        first_dev = torch.argmax(logits, dim=-1).to(torch.int32)   # [bp, 1]
        self.prefill_calls += 1
        self.prefill_tokens += int(lens[:n].sum())
        self.prefill_padded_tokens += bp * blen
        first = first_dev.cpu().numpy()    # once per admitted bucket
        now = _now()
        slots = [a[1] for a in group]
        plens = [a[0].prompt_len for a in group]
        if self.paged:
            for s, p in zip(slots, plens):
                self.pool.positions[s] = p
        else:
            # ONE scatter moves every admitted row into its pool slot
            self.pool.write_rows(new_states, slots, plens)
        if not self.host_loop:
            sl = torch.tensor(slots, dtype=torch.long, device=dev)
            self._positions[sl] = torch.tensor(plens, dtype=torch.int32,
                                               device=dev)
            self.cur_tokens[sl] = first_dev[:n].reshape(n, 1)
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
        modes = self._choose_modes()
        bt = None
        if self.paged:
            for slot in self.active:   # this tick writes row pos per slot
                self.pool.alloc_pages(slot,
                                      int(self.pool.positions[slot]) + 1)
            bt = self.pool.block_table()
        dev = self.device
        logits, _ = SP.split_decode_step_mixed(
            self.params, self.stacked_bank,
            torch.from_numpy(self.cur_tokens.copy()).to(dev),
            self.pool.states, torch.from_numpy(self.pool.positions.copy()).to(dev),
            self.cfg, torch.from_numpy(modes).to(dev), bt)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

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

        k = self._window_len()
        bt = None
        if self.paged:
            # every row the window writes (pos..pos+k-1 per live slot) gets
            # its page before dispatch; the table ships as a fresh copy
            for slot in self.active:
                self.pool.alloc_pages(slot,
                                      int(self.pool.positions[slot]) + k)
            bt = self.pool.block_table()
        snapshot = sorted(self.active.items())
        modes_k = np.stack([self._choose_modes(self.tick + i, items=snapshot)
                            for i in range(k)])
        prev = self._inflight
        toks_k = self._run_window(modes_k, bt)
        self._inflight = (snapshot, toks_k, k)

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

    def _run_window(self, modes_k: np.ndarray, bt) -> torch.Tensor:
        """Enqueue K fused decode ticks on the device: each tick's tail
        token feeds the next tick's embed and positions advance on the
        device. Returns the window's [K, B, 1] int32 tokens (not read)."""
        modes_dev = torch.from_numpy(modes_k).to(self.device)
        tok, positions = self.cur_tokens, self._positions
        outs = []
        for i in range(modes_k.shape[0]):
            nxt, _ = SP.split_decode_step_mixed(
                self.params, self.stacked_bank, tok, self.pool.states,
                positions, self.cfg, modes_dev[i], bt, return_tokens=True)
            tok = nxt.to(torch.int32).reshape(tok.shape)
            outs.append(tok)
            positions = positions + 1
        self.cur_tokens, self._positions = tok, positions
        return torch.stack(outs)

    def _materialize(self, inflight):
        """Copy one window's token block to the host and append it to the
        snapshot's sessions; sessions whose budget completed move to
        ``finished`` (their slots were freed at dispatch)."""
        snapshot, toks_k, k = inflight
        arr = toks_k.cpu().numpy()                    # [K, B, 1]
        for slot, sess in snapshot:
            for i in range(k):
                sess.tokens.append(int(arr[i, slot].reshape(-1)[0]))
            budget = sess.gen_budget or sess.request.max_new_tokens
            if len(sess.tokens) >= budget:
                self.finished.append(sess)

    def _materialize_inflight(self):
        if self._inflight is not None:
            prev, self._inflight = self._inflight, None
            self._materialize(prev)

    def warm(self, prompt: np.ndarray, gen: int = 2):
        """Run every path a measured run can hit — each power-of-two prefill
        batch bucket up to the slot pool and (device loop) each
        power-of-two window length up to ``max_window`` — then zero the
        counters. ``prompt`` should have the measured run's length."""
        k = 1
        while True:
            n = min(k, self.pool.n_slots)
            self.run([Request(rid=-1 - i, prompt=np.asarray(prompt),
                              max_new_tokens=gen) for i in range(n)])
            if k >= self.pool.n_slots:
                break
            k <<= 1
        if not self.host_loop:
            w = 1
            while w <= self.max_window:
                self.run([Request(rid=-1 - i, prompt=np.asarray(prompt),
                                  max_new_tokens=w + 1)
                          for i in range(self.pool.n_slots)])
                w <<= 1
        self.reset_counters()

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

    def run(self, requests: Optional[List[Request]] = None,
            max_ticks: int = 100_000) -> List[Session]:
        """Drive the engine until every submitted request completes (or the
        tick budget runs out). Returns the finished sessions."""
        for r in requests or []:
            self.submit(r)
        for _ in range(max_ticks):
            if not self.step():
                break
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
        return {
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
