"""Live session migration between edge decoder replicas (mmWave handover;
the port of ``repro.serving.migration``).

When a UE crosses a cell boundary mid-generation, its split session's
decode state lives on the *old* cell's edge server. The choices are to keep
serving it over a degraded inter-cell path (stay-and-degrade), to restart
the prompt on the new cell (drop-and-replay), or — this module — to move
the live decode state: one gather extracts the slot's per-layer state,
position, and current token as a :class:`MigrationSnapshot`; the snapshot
is (optionally) quantized for the simulated backhaul wire and charged for
transfer bytes/latency; and :func:`inject_session` installs it into a free
slot on the target replica's pool such that the migrated session's
remaining tokens are **bit-identical** to an unmigrated run (raw snapshots
— the gather/scatter pair is exact; quantized snapshots trade fidelity for
backhaul bytes, and tests measure both).

Dense pools (``SlotPool``) snapshot via ``read_rows`` — the slot's full
``[L, 1, cache_len, ...]`` rows. Paged pools (``PagedPool``) ship only the
session's **allocated pages**: ``PagedPool.read_pages`` gathers the slot's
block-table entries into ``[L, n_pages_used, page_len, ...]`` blocks in
block-table (= logical row) order, so the wire never carries the unused
tail of the arena. Page *ids* don't cross the backhaul — the target
allocates its own pages from its own free list and ``write_pages`` rebuilds
the block table — only the page contents and their logical order do.
Injection on a paged target is admission-equivalent: it re-commits the
session's worst-case page budget and returns ``False`` (park-and-retry at
the cluster) when the target arena can't cover it, exactly like
``_collect_admits`` backpressure.

Orchestration state migrates with the session: the per-link capacity EWMA
(:class:`~repro_torch.core.orchestrator.LinkState`), the session's
``AppRequirement``, and — under the adaptive policy — the controller's
``SlotControl`` (dwell timer, utilization EWMA) all detach from the source
and attach at the target, so mode selection after the handover continues
exactly where it left off instead of re-cold-starting.

Every migration is observable: an ``EdgeCluster`` built with
``telemetry=`` emits ``migrate_send`` / ``migrate_inject`` /
``migrate_park`` trace instants on the cluster lane (snapshot bytes,
simulated backhaul seconds) and folds the totals into
``cluster.migrations`` / ``cluster.migration_bytes`` counters plus the
``cluster.migration_backhaul_s`` histogram.

Wire format (``MigrationSnapshot.wire``): the state pytree is flattened;
each floating leaf is either shipped raw (``bits=0``) or symmetric
row-wise quantized at ``bits`` (codes + one scale per row — the same
``core.quant`` wire rules as the boundary payload, including the ternary
``bits=1`` 2-bit packing); integer leaves (e.g. int8 KV caches) always
ship raw. ``nbytes`` is the accounted backhaul payload:
``quant.payload_bytes`` per leaf plus the position/token header.

The snapshot is host numpy and carries no device: ``_encode_state``
copies each leaf to the host (a bfloat16 leaf as its uint16 bit pattern,
with its dtype recorded), and ``_decode_state`` rebuilds the leaves on the
target engine's device, so a snapshot injects into any replica. Leaves are
flattened in the reference's order (dict keys sorted, as ``jax.tree``
flattens), so both packages' snapshots of the same session list the same
leaves in the same order with equal ``nbytes``. Raw snapshots stay
bit-exact across the migration: the target's pool rows and the page
contents in logical order are the source's, and the decode kernels' sums
do not depend on the slot index, the other rows or the page ids.

On a serving mesh (``engine.mesh``) the snapshot is mesh-blind:
``read_rows`` / ``read_pages`` gather the slot's rows (every KV head)
from the ranks that hold them onto every rank of the engine's scope (an
integer sum of zero-padded parts, so the bytes are exact), every rank
encodes the same bytes, and injection writes each target rank's own rows
and heads. A snapshot from a sharded engine is byte-identical to the
unsharded engine's at the same tick.

The engine-facing functions are free functions over
``ContinuousBatchingEngine`` internals rather than engine methods — the
cluster router (``serving/cluster.py``) is their only intended caller, and
keeping them here keeps the engine unaware of multi-replica topology. The
in-place writes of ``write_rows`` / ``write_pages`` and
``batcher._admit_meta`` (``index_copy_``) are the counterpart of the
reference's donated scatters; nothing is donated, so the reference's
``_sync_device_state`` has no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.orchestrator import AppRequirement, LinkState
from repro_torch.serving.batcher import ContinuousBatchingEngine, _admit_meta
from repro_torch.serving.controller import SlotControl
from repro_torch.serving.session import Session

#: accounted wire overhead per snapshot beyond the state leaves: position
#: and rid/routing metadata (the current token is charged separately at
#: 4 bytes per value: an audio session's [K, 1] row carries one a
#: codebook)
SNAPSHOT_HEADER_BYTES = 16


@dataclass
class MigrationSnapshot:
    """One live session's complete decode state, off-pool and serializable.

    ``wire`` holds one entry per state leaf: ``("raw", array, dtype_str)``
    or ``("q", codes, scales, dtype_str)`` (host numpy; a bfloat16 leaf
    travels as its uint16 bit pattern); ``treedef`` restores the tree.
    """
    session: Session
    position: int
    cur_token: np.ndarray              # the token the next decode step eats
    wire: List[tuple]
    treedef: Any
    bits: int                          # 0 = raw (bit-exact) snapshot
    nbytes: int                        # accounted backhaul payload
    link: Optional[LinkState] = None
    requirement: Optional[AppRequirement] = None
    control: Optional[SlotControl] = None
    source_replica: int = -1
    #: True when ``wire`` holds allocated page blocks (source pool was a
    #: ``PagedPool``) rather than dense slot rows; ``page_len`` then records
    #: the source page geometry so the target can reject a mismatch
    paged: bool = False
    page_len: int = 0

    @property
    def rid(self) -> Hashable:
        return self.session.request.rid


def _flatten(tree) -> Tuple[list, Any]:
    """Leaves of a nested dict / list / tuple in ``jax.tree`` order (dict
    keys sorted) and a skeleton that keeps the tree's own key order, with
    each leaf's index in its place."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            idx = {k: walk(t[k]) for k in sorted(t)}
            return {k: idx[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        leaves.append(t)
        return len(leaves) - 1

    return leaves, walk(tree)


def _unflatten(treedef, leaves: list):
    if isinstance(treedef, dict):
        return {k: _unflatten(v, leaves) for k, v in treedef.items()}
    if isinstance(treedef, (list, tuple)):
        return type(treedef)(_unflatten(v, leaves) for v in treedef)
    return leaves[treedef]


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's values as host numpy (bfloat16 as its uint16
    bits); never a view of pool memory."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _device(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _encode_state(state, bits: int) -> Tuple[List[tuple], Any, int]:
    """Flatten a single-slot state tree into wire entries + byte count.

    Floating leaves quantize at ``bits`` (row-wise over the last dim, the
    same symmetric scheme as the boundary payload); integer leaves ship
    raw — re-quantizing codes would corrupt them.
    """
    leaves, treedef = _flatten(state)
    wire: List[tuple] = []
    nbytes = SNAPSHOT_HEADER_BYTES
    for leaf in leaves:
        dtype = str(leaf.dtype).replace("torch.", "")
        shape = tuple(leaf.shape)
        if bits and leaf.ndim and leaf.is_floating_point():
            codes, scales = quant.quantize(leaf, bits)
            wire.append(("q", _host(codes), _host(scales), dtype))
            nbytes += quant.payload_bytes(shape, bits)
        else:
            wire.append(("raw", _host(leaf), dtype))   # the wire copy
            nbytes += quant.payload_bytes(shape, 0,
                                          dtype_bytes=leaf.element_size())
    return wire, treedef, nbytes


def _decode_state(snap: MigrationSnapshot, device):
    """Rebuild the batched (batch=1 on the slot axis) state tree the target
    pool's ``write_rows`` / ``write_pages`` expects, on ``device``."""
    leaves = []
    for entry in snap.wire:
        if entry[0] == "raw":
            leaves.append(_device(entry[1], entry[2], device))
        else:
            _, codes, scales, dtype = entry
            x = quant.dequantize(_device(codes, "int8", device),
                                 _device(scales, "float32", device),
                                 snap.bits)
            leaves.append(x.to(getattr(torch, dtype)))
    return _unflatten(snap.treedef, leaves)


def _land_and_find(eng: ContinuousBatchingEngine, rid: Hashable) -> int:
    """Locate ``rid``'s slot and land the lagged window: token values for
    every dispatched tick must be on the session before the slot is read
    or released. Raises ``KeyError`` if ``rid`` is not live on this engine
    (it may have finished already — callers must check before acting on a
    handover)."""
    slot = next((s for s, sess in eng.active.items()
                 if sess.request.rid == rid), None)
    if slot is None:
        raise KeyError(f"request {rid!r} is not live on this engine")
    eng._materialize_inflight()
    return slot


def _detach(eng: ContinuousBatchingEngine, slot: int, rid: Hashable
            ) -> Tuple[Session, Optional[LinkState],
                       Optional[AppRequirement], Optional[SlotControl]]:
    """Detach the session's orchestrator/controller state and free its
    slot (the window must already be landed — see ``_land_and_find``)."""
    sess = eng.active[slot]
    link = requirement = control = None
    if eng.controller is not None:
        control = eng.controller.detach(rid)
    if eng.orch is not None:
        link, requirement = eng.orch.detach(rid)
    del eng.active[slot]
    eng.pool.release(slot)
    return sess, link, requirement, control


def detach_session(eng: ContinuousBatchingEngine, rid: Hashable
                   ) -> Tuple[Session, Optional[LinkState],
                              Optional[AppRequirement],
                              Optional[SlotControl]]:
    """Remove a live session from ``eng`` WITHOUT snapshotting its decode
    state. This is the whole of what drop-and-replay needs — the state is
    abandoned, so no device->host copy happens."""
    return _detach(eng, _land_and_find(eng, rid), rid)


def extract_session(eng: ContinuousBatchingEngine, rid: Hashable, *,
                    bits: int = 0,
                    source_replica: int = -1) -> MigrationSnapshot:
    """Pull a live session off ``eng`` WITH its decode state: gather the
    slot's state (``SlotPool.read_rows`` dense rows, or the allocated
    page blocks via ``PagedPool.read_pages``), encode them for the
    backhaul wire, then detach. The engine keeps running — the extracted
    session simply stops decoding here.

    ``bits=0`` snapshots are bit-exact; ``bits>0`` quantizes floating
    leaves for the backhaul wire (lossy). Raises ``KeyError`` if ``rid``
    is not live on this engine.
    """
    slot = _land_and_find(eng, rid)
    paged = bool(getattr(eng.pool, "paged", False))
    if paged:
        state = eng.pool.read_pages(slot)
    else:
        state = eng.pool.read_rows([slot])
    wire, treedef, nbytes = _encode_state(state, bits)
    # a copy, not a view of the engine's token row: a parked snapshot must
    # keep its token while the source slot serves another session
    cur = eng.cur_tokens[slot]
    tok = (_host(cur) if torch.is_tensor(cur) else np.array(cur)).astype(
        np.int32)
    nbytes += int(tok.size) * 4
    sess, link, requirement, control = _detach(eng, slot, rid)
    return MigrationSnapshot(session=sess, position=int(sess.pos),
                             cur_token=tok, wire=wire, treedef=treedef,
                             bits=bits, nbytes=nbytes, link=link,
                             requirement=requirement, control=control,
                             source_replica=source_replica, paged=paged,
                             page_len=eng.pool.page_len if paged else 0)


def inject_session(eng: ContinuousBatchingEngine,
                   snap: MigrationSnapshot) -> bool:
    """Install a snapshot into a free slot on ``eng``. Returns ``False``
    (and changes nothing) when the pool is full — or, on a paged target,
    when the arena cannot cover the session's worst-case remaining page
    budget — the caller queues the snapshot and retries after a
    retirement frees slots/pages.

    The writes are the admission path's own (``write_rows`` /
    ``write_pages``, then on the device loop ``_admit_meta`` for the
    position and token), so an injected
    raw snapshot is indistinguishable from having decoded every prior
    token on this engine — the remaining stream is bit-identical. No
    channel tick is consumed: injection is not an admission, and the UE's
    link realization must continue unbroken across the handover.
    """
    target_paged = bool(getattr(eng.pool, "paged", False))
    if snap.paged != target_paged:
        raise ValueError(
            f"snapshot pool kind ({'paged' if snap.paged else 'dense'}) "
            f"does not match target pool "
            f"({'paged' if target_paged else 'dense'}) — cluster replicas "
            "must share their pool configuration")
    if snap.paged and snap.page_len != eng.pool.page_len:
        raise ValueError(
            f"snapshot page_len {snap.page_len} does not match target "
            f"page_len {eng.pool.page_len}")
    if eng.pool.n_free == 0:
        return False
    sess, rid = snap.session, snap.rid
    dev = eng.device
    if snap.paged:
        # admission-equivalent page budgeting: the migrated session must be
        # able to finish here, so re-commit its worst-case total pages
        # (prompt + clipped budget rows; the last generated token writes no
        # row) before touching the free list — False parks the snapshot at
        # the cluster until retirements free enough pages
        plen = eng.pool.page_len
        budget = sess.gen_budget or sess.request.max_new_tokens
        worst = -(-(sess.request.prompt_len + budget - 1) // plen)
        nbu = snap.wire[0][1].shape[1]
        worst = max(worst, nbu)
        if worst > eng.pool.pages_available:
            return False
        state = _decode_state(snap, dev)
        slot = eng.pool.acquire()
        eng.pool.commit_pages(slot, worst)
        eng.pool.write_pages(slot, state, snap.position)
    else:
        state = _decode_state(snap, dev)
        slot = eng.pool.acquire()
        eng.pool.write_rows(state, [slot], [snap.position], full_heads=True)
    if eng.host_loop:
        eng.cur_tokens[slot] = snap.cur_token
    else:
        _admit_meta(eng._positions, eng.cur_tokens,
                    torch.tensor([slot], dtype=torch.long, device=dev),
                    torch.tensor([snap.position], dtype=torch.int32,
                                 device=dev),
                    torch.from_numpy(snap.cur_token).to(dev)[None])
    sess.slot = slot
    eng.active[slot] = sess
    if eng.orch is not None:
        # re-attach the migrated link state (capacity EWMA, mode, tick
        # count) so post-handover mode selection continues where it left
        # off; a fresh register() would re-cold-start the EWMA
        eng.orch.attach(rid, snap.link, snap.requirement)
        eng.orch.register(rid, snap.requirement)   # no-op if attached
    if eng.controller is not None and snap.control is not None:
        eng.controller.attach(rid, snap.control)
    return True
