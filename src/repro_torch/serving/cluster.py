"""Edge-cluster serving: N decoder replicas behind a router, with live
session migration on mmWave cell handover and fleet-scale elasticity (the
port of ``repro.serving.cluster``).

The paper's mobile-edge setting has one decoder per cell's edge server.
Serving real traffic therefore means a *cluster*: ``EdgeCluster`` owns N
``ContinuousBatchingEngine`` replicas (replica ``i`` fronts cell ``i``), a
router with pluggable placement policies, and a handover loop driven by
each UE's mobility channel — when a UE crosses a cell boundary
mid-generation, the cluster applies one of three policies:

``migrate``
    Live migration (``serving/migration.py``): extract the session's slot
    state as a :class:`~repro_torch.serving.migration.MigrationSnapshot`
    (optionally quantized at ``snapshot_bits``), charge the simulated
    backhaul for its bytes/latency, and inject it into a free slot on the
    new cell's replica. Raw snapshots keep the remaining token stream
    bit-identical to an unmigrated run.
``stay``
    Stay-and-degrade: the session keeps decoding on the old replica while
    the channel's ``detach_factor`` throttles every subsequent uplink
    transfer — the baseline migration is measured against.
``drop``
    Drop-and-replay: retire the partial session and resubmit
    ``prompt + emitted tokens`` as a fresh prompt on the new replica —
    no state crosses the backhaul, but the whole context re-uploads and
    re-prefills. The cluster folds the partial accounting into the replay
    session's final result.

Placement policies (new-request routing):

``least-loaded``   replica with the fewest active + queued sessions;
``best-channel``   the replica fronting the UE's current physical cell
                   (mobility channels; others fall back to least-loaded);
``round-robin``    strict rotation.

Mobility is duck-typed (:func:`~repro_torch.core.channel.is_mobile`): scalar
``MobilityChannel`` objects and the vectorized
:class:`~repro_torch.core.channel.FleetChannel` lane views are interchangeable,
so a 10k-UE fleet rides one array-stepped channel with no per-UE Python
objects on the hot path.

**Elasticity** (fleet-scale serving): with an
:class:`~repro_torch.serving.controller.Autoscaler` attached, every cluster
step feeds it live occupancy / queue-backlog / session-SLO-miss signals
and applies its decision — ``scale_up`` adds a replica (a new pool over
the same shared weight tensors: N replicas cost N pools, not N models),
``scale_down`` *retires* one: the replica index stays in place (the
cell-fronting modulo map and ``_home`` entries never shift), new work
routes around it, and its live sessions drain out through the existing
migration path until it is empty — scale-down never strands a session.
With an :class:`~repro_torch.serving.fleet.SLOAdmission` gate attached,
``submit`` rejects requests whose *predicted* completion already misses
their session SLO (hopeless link, or queue wait + service time beyond
``slo_ticks``) and parks requests under transient backlog the autoscaler
may relieve — parked requests retry every step and age out to terminal
rejections after ``park_max_ticks``.

Replicas are independent engines: each has its own slot pool and its own
orchestrator/controller (per-edge-server control plane — migrated sessions
carry their link EWMA and dwell state across, see ``migration.py``), over
one set of weights (``T.prepare_params`` shares every tensor). Unlike the
reference, which gives each engine a pipeline thread so replicas overlap
their decode windows, this cluster ticks its replicas in turn on one host
thread and one CUDA stream; every replica's tick still runs the port's
kernels (one boundary, one decode tail and one ``paged_attention`` a
layer on the paged pool).

``dp`` / ``mp`` put each replica on a serving mesh of its own ranks:
replica ``i`` takes global ranks ``[i * dp * mp, (i + 1) * dp * mp)`` of
the initialized ``torch.distributed`` world as its engine group, and every
rank of the world keeps every replica's host state (the scope of each
replica's mesh), so the router runs on every rank. The routing and
migration decisions are the world rank 0's (one broadcast each; a rank
whose own decision differs raises). A migration snapshot is gathered on
every rank from the source replica's holders (mesh-blind bytes, see
``migration.py``) and injected on the target group. Elastic scaling with a
mesh raises ``ValueError``, as the reference's does.
"""
from __future__ import annotations

import heapq
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bottleneck
from repro_torch.core.channel import is_mobile, tx_seconds
from repro_torch.core.orchestrator import (AppRequirement, ModeProfile,
                                           Orchestrator)
from repro_torch.models import sharding
from repro_torch.serving.batcher import ContinuousBatchingEngine
from repro_torch.serving.controller import Autoscaler
from repro_torch.serving.fleet import SLOAdmission
from repro_torch.serving.migration import (detach_session, extract_session,
                                           inject_session)
from repro_torch.serving.session import Request, Session
from repro_torch.serving.telemetry import Telemetry

PLACEMENTS = ("least-loaded", "best-channel", "round-robin")
HANDOVER_POLICIES = ("migrate", "stay", "drop")


def default_orchestrator(cfg: ModelConfig,
                         latency_budget_s: float = 0.006, *,
                         ema: float = 0.5,
                         hysteresis: float = 1.0) -> Orchestrator:
    """One per-replica control plane from the analytic payload model (the
    same calibration ``launch/serve.py`` uses for smoke weights). The
    serving benchmarks build theirs through here too, so an A/B bench and
    the cluster can never drift onto different calibrations."""
    return Orchestrator(
        [ModeProfile(m, bottleneck.mode_payload_bytes(cfg, 1, 1, m), float(m))
         for m in range(cfg.split.n_modes)],
        AppRequirement(latency_budget_s=latency_budget_s),
        ema=ema, hysteresis=hysteresis)


class EdgeCluster:
    """N-replica split-serving cluster with handover-aware routing.

    ``make_orchestrator``/``make_controller`` are per-replica factories
    ``(replica_idx) -> Orchestrator | ModeController | None``; the default
    builds an independent :func:`default_orchestrator` per replica. Every
    engine kwarg (``host_loop``, ``max_window``, ``max_pending``, ...)
    passes through ``engine_kwargs``.

    ``admission`` attaches an :class:`SLOAdmission` gate to ``submit``;
    ``autoscaler`` attaches an :class:`Autoscaler` whose per-step
    decisions drive :meth:`scale_up`/:meth:`scale_down`.

    Without ``dp`` / ``mp`` every replica lives on the device of
    ``params``. With them, each replica is a serving mesh over its own
    ranks (see the module docstring); ``devices``: each global rank's
    device (a sequence indexed by rank, or one device for this rank),
    default ``cuda:<rank>``.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_replicas: int = 2,
                 n_slots: int = 4, cache_len: int = 128,
                 placement: str = "least-loaded",
                 handover: str = "migrate",
                 snapshot_bits: int = 0,
                 backhaul_bps: float = 1.25e9,
                 latency_budget_s: float = 0.006,
                 make_orchestrator=None, make_controller=None,
                 admission: Optional[SLOAdmission] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 telemetry: Optional[Telemetry] = None,
                 dp: Optional[int] = None, mp: Optional[int] = None,
                 devices=None,
                 **engine_kwargs):
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}")
        if handover not in HANDOVER_POLICIES:
            raise ValueError(
                f"handover must be one of {HANDOVER_POLICIES}")
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self._meshes = None
        if dp is not None or mp is not None or devices is not None:
            self._meshes = self._build_meshes(n_replicas, dp or 1, mp or 1,
                                              devices, autoscaler)
        self.cfg = cfg
        self.placement = placement
        self.handover = handover
        self.snapshot_bits = int(snapshot_bits)
        self.backhaul_bps = float(backhaul_bps)
        self.admission = admission
        self.autoscaler = autoscaler
        #: shared telemetry: lane 0 carries control-plane events
        #: (admission, migration, autoscale); replica ``i`` writes lane
        #: ``i + 1`` via its engine's Telemetry view (see ``_new_engine``)
        self._tel = telemetry
        if telemetry is not None:
            telemetry.trace.set_lane(telemetry.lane, "cluster")
            if admission is not None:
                admission.telemetry = telemetry
        # replica-construction closure state: scale_up builds new engines
        # from exactly what __init__ built the originals from (the same
        # weight tensors, a new pool)
        self._params = params
        self._n_slots = int(n_slots)
        self._cache_len = int(cache_len)
        self._latency_budget_s = float(latency_budget_s)
        self._make_orchestrator = make_orchestrator
        self._make_controller = make_controller
        self._engine_kwargs = dict(engine_kwargs)
        self.replicas: List[ContinuousBatchingEngine] = []
        for i in range(n_replicas):
            self.replicas.append(self._new_engine(i))
        #: replica indices that are draining toward removal from service.
        #: Indices are STABLE — the list never shrinks, so the cell ->
        #: replica modulo map and every ``_home`` entry stay valid; a
        #: retired index can be revived by a later scale_up.
        self.retired: set = set()
        self._rr = 0                       # round-robin cursor
        self._home: Dict[Hashable, int] = {}
        #: snapshots/replays that could not land yet (target pool or queue
        #: full); retried every cluster step
        self._parked: List[tuple] = []
        #: admission-parked requests (req, parked_since_clock); re-decided
        #: every cluster step, aged out to terminal rejections
        self._slo_parked: List[Tuple[Request, int]] = []
        #: partial sessions superseded by a drop-and-replay, folded into
        #: the replay session's result at collection
        self._replay_base: Dict[Hashable, Session] = {}
        self.finished: List[Session] = []
        #: per-replica high-water mark into eng.finished (append-only), so
        #: collect() is O(new finishes), not O(all finishes) per sweep
        self._collect_offsets: List[int] = [0] * n_replicas
        self.clock = 0                     # cluster steps taken
        # cluster-level counters
        self.submitted = 0                 # router-level submit attempts
        self.migrations = 0
        self.migration_bytes = 0
        self.migration_transfer_s = 0.0
        self.replays = 0
        self.replayed_tokens = 0
        self.handovers = 0                 # boundary crossings acted on
        self.handovers_ignored = 0         # crossings under the stay policy
        self.rejected = 0                  # router-level submit rejections
        self.slo_rejected = 0              # admission-gate rejections
        self.slo_park_expired = 0          # parked past park_max_ticks
        self.scale_ups = 0
        self.scale_downs = 0
        #: (clock, "up"/"down", replica_idx) per elasticity action
        self.scale_events: List[Tuple[int, str, int]] = []
        # windowed session-SLO signal for the autoscaler
        self._obs_finished = 0
        self._obs_late = 0

    @staticmethod
    def _build_meshes(n_replicas: int, dp: int, mp: int, devices,
                      autoscaler):
        """One serving mesh per replica on disjoint rank groups, each
        mirrored by every rank of the world."""
        if autoscaler is not None:
            raise ValueError("elastic scaling (an autoscaler) cannot add or "
                             "retire replicas on a fixed set of ranks: "
                             "serve a mesh without one")
        rank, size = sharding.world()
        need = n_replicas * dp * mp
        if need > size:
            raise ValueError(
                f"{n_replicas} replicas of a ({dp} x {mp}) mesh need {need} "
                f"ranks, one device each, but the world has {size}: start "
                f"{need} ranks (torchrun --nproc-per-node {need}, or "
                f"launch.serve --dp/--mp)")
        if devices is not None and not isinstance(devices, (str,
                                                            torch.device)):
            devices = list(devices)[rank]
        return [sharding.serving_mesh(
            dp, mp, ranks=range(i * dp * mp, (i + 1) * dp * mp),
            device=devices, scope_ranks=range(size))
            for i in range(n_replicas)]

    def _agree(self, values, what: str):
        """World rank 0's routing decision (one broadcast on a mesh)."""
        if self._meshes is not None:
            self._meshes[0].agree(values, what, src=0)

    def _new_engine(self, i: int) -> ContinuousBatchingEngine:
        kw = dict(self._engine_kwargs)
        if self._meshes is not None:
            kw["mesh"] = self._meshes[i]
        if self._tel is not None:
            kw["telemetry"] = self._tel.for_lane(i + 1, f"replica{i}")
        if self._make_controller is not None:
            ctl = self._make_controller(i)
            if ctl is not None:
                kw["controller"] = ctl
        elif self._make_orchestrator is not None:
            kw["orchestrator"] = self._make_orchestrator(i)
        else:
            kw["orchestrator"] = default_orchestrator(
                self.cfg, self._latency_budget_s)
        return ContinuousBatchingEngine(
            self._params, self.cfg, n_slots=self._n_slots,
            cache_len=self._cache_len, **kw)

    # -- routing --------------------------------------------------------------
    def _live(self) -> List[int]:
        return [i for i in range(len(self.replicas))
                if i not in self.retired]

    @property
    def n_live(self) -> int:
        return len(self.replicas) - len(self.retired)

    def _load(self, eng: ContinuousBatchingEngine) -> int:
        return len(eng.active) + len(eng.queue) + len(eng._pending)

    def _least_loaded(self) -> int:
        return min(self._live(),
                   key=lambda i: (self._load(self.replicas[i]), i))

    def _route_cell(self, cell: int) -> int:
        """Cell -> replica under the modulo map, detouring around retired
        replicas (a retired index must never receive NEW work)."""
        r = int(cell) % len(self.replicas)
        return r if r not in self.retired else self._least_loaded()

    def place(self, req: Request) -> int:
        """Pick the home replica for a new request under the configured
        placement policy (exposed for tests and custom routers)."""
        if self.placement == "round-robin":
            live = self._live()
            r = live[self._rr % len(live)]
            self._rr += 1
            return r
        if self.placement == "best-channel" and is_mobile(req.channel):
            return self._route_cell(req.channel.current_cell)
        return self._least_loaded()

    def _predicted_wait_ticks(self, req: Request) -> int:
        """Queue-wait prediction the admission gate measures against the
        request's session SLO: waiting requests ahead of it, beyond the
        currently free slots, each occupy a slot for roughly one service
        time (1 token/tick greedy decode)."""
        live = [self.replicas[i] for i in self._live()]
        free = sum(e.pool.n_free for e in live)
        # only DUE backlog counts: scheduled future arrivals (engine
        # ``_pending`` heaps) are not waiting ahead of this request — by
        # their arrival ticks today's occupants will have drained
        waiting = sum(len(e.queue) for e in live) + len(self._slo_parked)
        slots = sum(e.pool.n_slots for e in live)
        if waiting < free:
            return 0
        service = req.max_new_tokens + req.prompt_len
        return int(np.ceil((waiting - free + 1) / max(slots, 1)) * service)

    def _queue_per_slot(self) -> float:
        live = [self.replicas[i] for i in self._live()]
        waiting = sum(len(e.queue) for e in live)
        return waiting / max(sum(e.pool.n_slots for e in live), 1)

    def submit(self, req: Request) -> bool:
        """Route a request to its home replica. Returns False when the
        admission gate rejected it (predicted SLO miss / hopeless link)
        or that replica's admission queue rejected it (back-pressure).

        Mobility scripts must only name cells this cluster fronts
        (replica ``i`` fronts cell ``i``): a cell id >= ``n_replicas``
        would alias onto some replica under the modulo map and a crossing
        into it could be misread as "crossed back into the serving cell",
        silently disabling migration for the session — so it is an error.
        """
        self.submitted += 1
        if is_mobile(req.channel) and \
                int(req.channel.cells.max()) >= len(self.replicas):
            raise ValueError(
                f"request {req.rid!r}: mobility script names cell "
                f"{int(req.channel.cells.max())} but the cluster has only "
                f"{len(self.replicas)} replicas (replica i fronts cell i)")
        if self.admission is not None:
            verdict = self._decide(req)
            if verdict == "reject":
                self.slo_rejected += 1
                return False
            if verdict == "park":
                self._slo_parked.append((req, self.clock))
                return True            # accepted, deferred
        return self._route(req)

    def _decide(self, req: Request) -> str:
        peek = getattr(req.channel, "peek", None)
        return self.admission.decide(
            slo_ticks=req.slo_ticks,
            predicted_wait_ticks=self._predicted_wait_ticks(req),
            service_ticks=req.max_new_tokens,
            capacity_bps=peek() if peek is not None else None,
            queue_per_slot=self._queue_per_slot(), rid=req.rid)

    @staticmethod
    def _try_submit(eng: ContinuousBatchingEngine, req: Request) -> bool:
        """Engine submit that does NOT bump the engine's queue-rejection
        counter on a full queue — the caller rejects/parks and counts the
        outcome itself. This keeps ``eng.queue.rejected`` meaning exactly
        one thing (a deferred arrival came due while the queue was full:
        one bump, one terminated request), so the cluster's conservation
        law balances: a parked replay retried N times against a full
        queue must not count as N rejections."""
        if req.arrival_tick <= eng.tick \
                and len(eng.queue) >= eng.queue.max_pending:
            return False
        return eng.submit(req)

    def _route(self, req: Request) -> bool:
        r = self.place(req)
        self._agree([r], f"placement of request {req.rid!r}")
        if is_mobile(req.channel):
            # the session will be served from replica r's cell until a
            # migration (or drop-and-replay) re-homes it
            req.channel.serving_cell = r
        ok = self._try_submit(self.replicas[r], req)
        if ok:
            self._home[req.rid] = r
        else:
            self.rejected += 1
        return ok

    # -- elasticity -----------------------------------------------------------
    def scale_up(self) -> int:
        """Add serving capacity: revive a fully-drained retired replica if
        one exists (its engine is empty and its pool already allocated),
        else append a new replica built from the constructor's stored
        state — a new pool over the same weight tensors. Returns the
        replica index now in service."""
        if self._meshes is not None:
            raise ValueError("a cluster on serving meshes has a fixed set "
                             "of replicas")
        for i in sorted(self.retired):
            if self._load(self.replicas[i]) == 0:
                self.retired.discard(i)
                self.scale_ups += 1
                self.scale_events.append((self.clock, "up", i))
                return i
        self.replicas.append(self._new_engine(len(self.replicas)))
        self._collect_offsets.append(0)
        self.scale_ups += 1
        idx = len(self.replicas) - 1
        self.scale_events.append((self.clock, "up", idx))
        return idx

    def scale_down(self, idx: Optional[int] = None) -> Optional[int]:
        """Retire one replica (default: the least-loaded live one). The
        index stays in the replica list — routing just stops offering it
        new work — and its sessions drain out via the migration path over
        subsequent steps, so no live session is ever stranded. Returns
        the retired index, or None when already at one live replica."""
        if self.n_live <= 1:
            return None
        if idx is None:
            idx = self._least_loaded()
        if idx in self.retired:
            return None
        self.retired.add(idx)
        self.scale_downs += 1
        self.scale_events.append((self.clock, "down", idx))
        # waiting work re-routes immediately; only in-flight slots drain
        eng = self.replicas[idx]
        while True:
            req = eng.queue.pop()
            if req is None:
                break
            self._route(req)
        while eng._pending:
            self._route(heapq.heappop(eng._pending)[2])
        return idx

    def _drain_retired(self) -> bool:
        """Push every retired replica's live sessions out through the
        migration machinery (drop-and-replay under the ``drop`` policy —
        it ships no state). Runs every step until the engines are empty;
        a full target parks the move and the next step retries."""
        acted = False
        for r in sorted(self.retired):
            eng = self.replicas[r]
            if not eng.active:
                continue
            for slot, sess in sorted(eng.active.items()):
                target = self._least_loaded()
                acted = True
                if self.handover == "drop" \
                        and sess.request.prompt.ndim == 1:
                    self._drop_replay(eng, r, sess, target)
                else:
                    self._migrate(eng, r, sess, target)
        return acted

    def _observe_autoscaler(self):
        live = [self.replicas[i] for i in self._live()]
        occ = float(np.mean([len(e.active) / max(e.pool.n_slots, 1)
                             for e in live]))
        finished, late = self._obs_finished, self._obs_late
        self._obs_finished = self._obs_late = 0
        miss_rate = late / finished if finished else 0.0
        decision = self.autoscaler.observe(
            n_replicas=self.n_live, occupancy=occ,
            queue_per_slot=self._queue_per_slot(), miss_rate=miss_rate)
        if decision > 0:
            idx = self.scale_up()
        elif decision < 0:
            idx = self.scale_down()
        if decision and self._tel is not None:
            # the autoscaler just appended its (tick, ±1, reason) event
            reason = self.autoscaler.events[-1][2]
            self._tel.instant(
                "autoscale_up" if decision > 0 else "autoscale_down",
                cat="autoscale", replica=idx, reason=reason,
                n_live=self.n_live, occupancy=round(occ, 3))

    # -- the cluster tick -----------------------------------------------------
    def step(self) -> bool:
        """One cluster tick: every replica advances one engine step (device
        replicas may cover a whole decode window), then pending handovers
        are applied, retired replicas drain, parked migrations/replays and
        admission-parked requests retry, and the autoscaler (if attached)
        observes and acts. Returns False when no replica has work and
        nothing is parked."""
        self.clock += 1
        progressed = [eng.step() for eng in self.replicas]
        acted = self._process_handovers()
        draining = self._drain_retired()
        drained = self._drain_parked()
        readmitted = self._retry_slo_parked()
        self.collect()                     # O(new finishes): SLO window
        if self.autoscaler is not None:
            self._observe_autoscaler()
        if self._tel is not None:
            self._tel.set("cluster.n_live", self.n_live)
            self._tel.set("cluster.queue_per_slot", self._queue_per_slot())
            self._tel.set("cluster.slo_parked", len(self._slo_parked))
            self._tel.set("cluster.parked_moves", len(self._parked))
        return (any(progressed) or acted or draining or drained
                or readmitted or bool(self._parked)
                or bool(self._slo_parked))

    def _retry_slo_parked(self) -> bool:
        if not self._slo_parked:
            return False
        still: List[Tuple[Request, int]] = []
        acted = False
        max_age = (self.admission.cfg.park_max_ticks
                   if self.admission is not None else 0)
        for req, since in self._slo_parked:
            if self.clock - since > max_age:
                self.slo_rejected += 1     # aged out: terminal rejection
                self.slo_park_expired += 1
                if self._tel is not None:
                    self._tel.instant("slo_park_expired", cat="admission",
                                      rid=req.rid,
                                      parked_ticks=self.clock - since)
                acted = True
                continue
            verdict = self._decide(req) if self.admission is not None \
                else "admit"
            if verdict == "reject":
                self.slo_rejected += 1
                acted = True
            elif verdict == "admit":
                self._route(req)
                acted = True
            else:
                still.append((req, since))
        self._slo_parked = still
        return acted

    def _process_handovers(self) -> bool:
        acted = False
        for r, eng in enumerate(self.replicas):
            for slot, sess in sorted(eng.active.items()):
                ch = sess.request.channel
                if not is_mobile(ch):
                    continue
                pending = ch.pending_handover
                if pending is not None:
                    sess.handover_ticks = list(ch.handover_ticks)
                    acted = True
                    self.handovers += 1
                    if self._tel is not None:
                        self._tel.inc("cluster.handovers")
                        self._tel.instant(
                            "handover", cat="migration",
                            rid=sess.request.rid, from_replica=r,
                            to_cell=int(pending), policy=self.handover)
                    if self.handover == "stay":
                        # acknowledge the event but keep the session where
                        # it is: every later uplink transfer pays
                        # detach_factor
                        ch.pending_handover = None
                        self.handovers_ignored += 1
                        continue
                    target = self._route_cell(pending)
                elif self.handover != "stay" and ch.detached \
                        and r not in self.retired:
                    # no crossing *event*, but the session is serving
                    # detached anyway — e.g. least-loaded placement put it
                    # on a replica that never fronted its cell. A migrating
                    # cluster corrects that instead of paying detach_factor
                    # for the session's whole life. (Retired replicas use
                    # the drain path instead.)
                    target = self._route_cell(ch.last_cell)
                    acted = True
                else:
                    continue
                if target == r:
                    ch.ack_handover(r)      # crossed back into home cell
                elif self.handover == "migrate":
                    self._migrate(eng, r, sess, target)
                else:                        # drop-and-replay
                    self._drop_replay(eng, r, sess, target)
        return acted

    def _migrate(self, eng, r: int, sess: Session, target: int):
        self._agree([r, target, sess.slot],
                    f"migration of request {sess.request.rid!r}")
        snap = extract_session(eng, sess.request.rid,
                               bits=self.snapshot_bits, source_replica=r)
        t = tx_seconds(snap.nbytes, self.backhaul_bps)
        sess.migrations.append({
            "kind": "migrate", "tick": eng.tick, "from_replica": r,
            "to_replica": target, "bytes": snap.nbytes,
            "bits": snap.bits, "transfer_s": round(t, 6)})
        sess.transfer_s += t
        self.migrations += 1
        self.migration_bytes += snap.nbytes
        self.migration_transfer_s += t
        if self._tel is not None:
            self._tel.inc("cluster.migrations")
            self._tel.inc("cluster.migration_bytes", snap.nbytes)
            self._tel.observe("cluster.migration_backhaul_s", t)
            self._tel.instant("migrate_send", cat="migration",
                              rid=snap.rid, from_replica=r,
                              to_replica=target, bytes=snap.nbytes,
                              transfer_s=round(t, 6))
        landed = inject_session(self.replicas[target], snap)
        if self._tel is not None:
            self._tel.instant("migrate_inject" if landed
                              else "migrate_park", cat="migration",
                              rid=snap.rid, to_replica=target)
        if landed:
            self._land(snap.rid, target, sess.request.channel)
        else:
            self._parked.append(("migrate", snap, target))

    def _drop_replay(self, eng, r: int, sess: Session, target: int):
        rid = sess.request.rid
        if sess.request.prompt.ndim != 1:
            raise NotImplementedError("drop-and-replay cannot reconstruct "
                                      "multi-codebook (audio) prompts from "
                                      "the emitted token stream")
        # drop ships no state: detach lands in-flight windows and frees
        # the slot without the device->host state copy a snapshot costs
        _, _, requirement, _ = detach_session(eng, rid)
        base = self._replay_base.get(rid)
        if base is not None:                # dropped before: fold the chain
            self._fold(base, sess)
        else:
            base = self._replay_base[rid] = sess
        # the replay prompt is the ORIGINAL prompt plus every token emitted
        # so far (across the whole drop chain) — greedy decode regenerates
        # the decoder state by prefilling the full context on the target
        budget = base.gen_budget or base.request.max_new_tokens
        remaining = budget - len(base.tokens)
        base.migrations.append({
            "kind": "replay", "tick": eng.tick, "from_replica": r,
            "to_replica": target, "bytes": 0, "bits": 0,
            "replayed_tokens": len(base.tokens)})
        self.replays += 1
        self.replayed_tokens += len(base.tokens)
        if self._tel is not None:
            self._tel.inc("cluster.replays")
            self._tel.instant("drop_replay", cat="migration", rid=rid,
                              from_replica=r, to_replica=target,
                              replayed_tokens=len(base.tokens))
        prompt = base.request.prompt
        req = Request(
            rid=rid,
            prompt=np.concatenate([prompt,
                                   np.asarray(base.tokens, prompt.dtype)]),
            max_new_tokens=max(remaining, 1),
            channel=base.request.channel,
            requirement=requirement or base.request.requirement,
            arrival_tick=self.replicas[target].tick,
            slo_ticks=base.request.slo_ticks)
        if self._try_submit(self.replicas[target], req):
            self._land(rid, target, req.channel)
        else:
            self._parked.append(("replay", req, target))

    def _land(self, rid: Hashable, target: int, ch) -> None:
        self._home[rid] = target
        if is_mobile(ch):
            ch.ack_handover(target)

    def _drain_parked(self) -> bool:
        still, drained = [], False
        for kind, item, target in self._parked:
            if target in self.retired:     # re-aim at a live replica
                target = self._least_loaded()
            if kind == "migrate":
                ok = inject_session(self.replicas[target], item)
                rid, ch = item.rid, item.session.request.channel
            else:
                ok = self._try_submit(self.replicas[target], item)
                rid, ch = item.rid, item.channel
            if ok:
                drained = True
                self._land(rid, target, ch)
            else:
                still.append((kind, item, target))
        self._parked = still
        return drained

    # -- collection -----------------------------------------------------------
    @staticmethod
    def _fold(base: Session, cont: Session) -> None:
        """Fold a continuation session's accounting into its base (the
        partial session a drop-and-replay superseded)."""
        base.tokens = base.tokens + cont.tokens
        base.wire_bytes += cont.wire_bytes
        base.prefill_wire_bytes += cont.prefill_wire_bytes
        base.transfer_s += cont.transfer_s
        base.deadline_misses += cont.deadline_misses
        base.escalations += cont.escalations
        base.migrations = base.migrations + cont.migrations
        base.mode_trace = base.mode_trace + cont.mode_trace
        base.finished_tick = cont.finished_tick
        for m, c in cont.mode_counts.items():
            base.mode_counts[m] = base.mode_counts.get(m, 0) + c

    @staticmethod
    def session_slo_late(sess: Session) -> bool:
        """True when the session finished past its request's session SLO
        (relative ticks: queue wait counts, replica clock skew doesn't)."""
        slo = sess.request.slo_ticks
        return (slo is not None and sess.finished_tick >= 0
                and sess.finished_tick - sess.request.arrival_tick > slo)

    def collect(self) -> List[Session]:
        """Sweep every replica's NEW finished sessions (per-replica offsets
        into the append-only ``eng.finished`` lists — O(new), not
        O(all-finished), per sweep) into the cluster-level list, folding
        drop-and-replay chains into one merged session per rid. Idempotent
        across calls; returns the cluster list."""
        while len(self._collect_offsets) < len(self.replicas):
            self._collect_offsets.append(0)
        for i, eng in enumerate(self.replicas):
            new = eng.finished[self._collect_offsets[i]:]
            self._collect_offsets[i] = len(eng.finished)
            for sess in new:
                rid = sess.request.rid
                base = self._replay_base.pop(rid, None)
                if base is not None:
                    self._fold(base, sess)
                    sess = base
                ch = sess.request.channel
                if is_mobile(ch):
                    sess.handover_ticks = list(ch.handover_ticks)
                self.finished.append(sess)
                self._obs_finished += 1
                if self.session_slo_late(sess):
                    self._obs_late += 1
        return self.finished

    def run(self, requests: Optional[Sequence[Request]] = None,
            max_ticks: int = 100_000) -> List[Session]:
        """Drive the cluster until every submitted request completes (or
        the tick budget runs out); returns the merged finished sessions."""
        for r in requests or []:
            self.submit(r)
        for _ in range(max_ticks):
            if not self.step():
                break
        return self._drain_and_collect()

    def run_paced(self, requests: Sequence[Request],
                  max_ticks: int = 100_000) -> List[Session]:
        """Like :meth:`run`, but each request is submitted when its
        ``arrival_tick`` comes due against the live engines' clock — the
        fleet-scale load runner. The admission gate then sees the backlog a
        real arrival would see, instead of judging every request at once
        against an empty cluster (or, worse, against thousands of
        scripted future arrivals)."""
        pending = sorted(requests, key=lambda r: r.arrival_tick)
        i = 0
        for _ in range(max_ticks):
            now = max((self.replicas[j].tick for j in self._live()),
                      default=0)
            while i < len(pending) and pending[i].arrival_tick <= now:
                self.submit(pending[i])
                i += 1
            progressed = self.step()
            if i >= len(pending) and not progressed:
                break
            if not progressed and i < len(pending):
                # idle gap before the next arrival: jump the live engines
                # forward instead of burning host steps one tick at a time
                nxt = pending[i].arrival_tick
                for j in self._live():
                    self.replicas[j].tick = max(self.replicas[j].tick, nxt)
        return self._drain_and_collect()

    def _drain_and_collect(self) -> List[Session]:
        for eng in self.replicas:
            eng._materialize_inflight()
        return self.collect()

    def warm(self, prompt: np.ndarray, gen: int = 2):
        """Run each replica's prefill batch buckets once before a measured
        run, then zero the counters. Unlike ``engine.warm`` this skips the
        per-window-length runs (~2 × ``max_window`` ticks a replica): a
        window of any length is the same eager tick run k times, and the
        replicas tick in turn on one host thread."""
        for eng in self.replicas:
            eng._warm_buckets(np.asarray(prompt), gen)
            eng.reset_counters()

    def close(self):
        """Land every replica's in-flight window (see
        ``ContinuousBatchingEngine.close``)."""
        for eng in self.replicas:
            eng.close()

    def __enter__(self) -> "EdgeCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- aggregate stats ------------------------------------------------------
    def stats(self) -> dict:
        self.collect()
        done = self.finished
        toks = sum(len(s.tokens) for s in done)
        # every admission's first token is a prefill argmax, and a
        # drop-and-replay chain re-admits once per replay — each fold
        # therefore contributes one more prefill-delivered (non-decode)
        # token that per-decode-token rates must not divide by
        dec = sum(max(len(s.tokens) - 1
                      - sum(1 for m in s.migrations
                            if m["kind"] == "replay"), 0)
                  for s in done)
        misses = sum(s.deadline_misses for s in done)
        late = sum(1 for s in done if self.session_slo_late(s))
        with_slo = sum(1 for s in done if s.request.slo_ticks is not None)
        latencies = []
        for s in done:
            ch = s.request.channel
            if is_mobile(ch):
                latencies.extend(ch.handover_latencies)
        per_replica = []
        over_capacity = queue_rejected = in_flight = 0
        for i, eng in enumerate(self.replicas):
            st = eng.stats()
            over_capacity += st["requests_over_capacity"]
            queue_rejected += st["requests_rejected"]
            in_flight += self._load(eng)
            per_replica.append({
                "replica": i,
                "retired": i in self.retired,
                "finished": st["requests_finished"],
                "active": len(eng.active),
                "queued": len(eng.queue),
                "free_slots": eng.pool.n_free,
                "decode_ticks": st["decode_ticks"],
                "decode_tokens": st["decode_tokens"],
                # decoded_slot_ticks counts work done ON this replica — a
                # migrated-in session's earlier tokens were decoded on its
                # previous home and must not inflate this occupancy
                "occupancy": round(
                    st["decoded_slot_ticks"]
                    / max(st["decode_ticks"] * eng.pool.n_slots, 1), 3),
            })
        out = {
            "n_replicas": len(self.replicas),
            "n_live": self.n_live,
            "placement": self.placement,
            "handover_policy": self.handover,
            "snapshot_bits": self.snapshot_bits,
            "requests_submitted": self.submitted,
            "requests_finished": len(done),
            "requests_rejected": self.rejected,
            "slo_rejected": self.slo_rejected,
            "slo_park_expired": self.slo_park_expired,
            "slo_parked_now": len(self._slo_parked),
            "generated_tokens": toks,
            "decode_tokens": dec,
            "wire_bytes": sum(s.wire_bytes for s in done),
            "decode_wire_bytes_per_token": (
                sum(s.wire_bytes - s.prefill_wire_bytes for s in done)
                / max(dec, 1)),
            "deadline_misses": misses,
            "deadline_miss_rate": misses / max(dec, 1),
            "session_slo_late": late,
            "sessions_with_slo": with_slo,
            # the A/B headline: of everything OFFERED, how much either
            # finished late or never ran at all (queue-wait-sensitive —
            # this is what admission + autoscaling move)
            "session_slo_miss_rate": (
                (late + self.slo_rejected + self.rejected + over_capacity)
                / max(self.submitted, 1)),
            "handovers": self.handovers,
            "handovers_ignored": self.handovers_ignored,
            "migrations": self.migrations,
            "migration_bytes": self.migration_bytes,
            "migration_transfer_s": round(self.migration_transfer_s, 6),
            "parked": len(self._parked),
            "replays": self.replays,
            "replayed_tokens": self.replayed_tokens,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "scale_events": list(self.scale_events),
            "mean_handover_latency_ticks": (
                float(np.mean(latencies)) if latencies else 0.0),
            #: submitted == every terminal outcome + work still in flight;
            #: the lifecycle fuzz asserts this balances exactly at drain
            #: (in_flight == 0). over_capacity counts engine-level
            #: admission rejections (prompt can't fit the cache).
            "conservation": {
                "submitted": self.submitted,
                "finished": len(done),
                "queue_rejected_router": self.rejected,
                "queue_rejected_engine": queue_rejected,
                "over_capacity": over_capacity,
                "slo_rejected": self.slo_rejected,
                "in_flight": in_flight,
                "slo_parked": len(self._slo_parked),
                "parked_moves": len(self._parked),
            },
            "per_replica": per_replica,
        }
        if self._tel is not None:
            self._tel.registry.ingest("cluster.stats", out)
        return out
