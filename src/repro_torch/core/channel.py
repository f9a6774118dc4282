"""UE <-> edge link simulation (a copy of ``repro.core.channel``).

The paper's orchestrator reacts to time-varying network conditions; this
module provides (i) a Gauss-Markov (AR(1)) capacity trace calibrated to
mmWave-like variability, (ii) a two-state (LoS/NLoS) Markov blockage overlay
— mmWave beams are highly directional and blockage-prone (paper Sec. V) —
and (iii) byte/latency accounting for latent-code transfers.

Deterministic given a seed: tests and the orchestrator bench replay traces.

Randomness is *counter-based*: every draw is a pure hash of
``(per-link key, tick, draw site)`` (splitmix64 finalizer, Box-Muller for
normals), so the scalar :class:`Channel` and the array-form
:class:`FleetChannel` evaluate the SAME function and their realizations are
bit-identical — the scalar classes stay the oracle for the vectorized fleet
— and a link's stream depends only on its own key, never on fleet size or
stepping order. Every realization equals the reference's draw for draw
(``tests/test_torch_channel_fleet.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

#: Default request/response round-trip added to every boundary transfer.
#: ``Orchestrator.choose_modes`` and ``tx_seconds`` must use the same value
#: or the vectorized and scalar feasibility paths would disagree.
RTT_SECONDS = 0.004


# -- counter-based RNG primitives ---------------------------------------------
# Draws are pure functions of (key, tick, salt): uint64 mixing constants from
# splitmix64 [Steele et al. 2014]. Vectorized over numpy uint64 arrays (which
# wrap silently on overflow — exactly the arithmetic we want); scalar callers
# go through 0-d arrays so no overflow warnings fire.

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
#: draw-site salts — each (key, tick) supports several independent draws
_SALT_FADE_A = np.uint64(0xA5A5A5A5A5A5A5A5)   # Box-Muller radius uniform
_SALT_FADE_B = np.uint64(0x5A5A5A5A5A5A5A5A)   # Box-Muller angle uniform
_SALT_BLOCK = np.uint64(0xC3C3C3C3C3C3C3C3)    # blockage Markov uniform
_U53 = 1.0 / float(1 << 53)


def _finalize(x: np.ndarray) -> np.ndarray:
    """splitmix64 output mixer (bijective on uint64)."""
    x = x ^ (x >> np.uint64(30))
    x = x * _MIX1
    x = x ^ (x >> np.uint64(27))
    x = x * _MIX2
    return x ^ (x >> np.uint64(31))


def _counter_hash(keys, ticks, salt: np.uint64) -> np.ndarray:
    """uint64 hash of ``(key, tick, draw site)`` — the one RNG primitive
    both the scalar and the fleet channel draw through (broadcasts).
    Everything runs as (at least 1-d) uint64 ARRAYS: array ops wrap
    silently on overflow, which is the modular arithmetic we want (scalar
    numpy ops would emit overflow warnings)."""
    k = np.atleast_1d(np.asarray(keys, np.uint64))
    t = np.atleast_1d(np.asarray(ticks, np.uint64))
    return _finalize(_finalize((k * _MIX2) ^ salt) + t * _GAMMA)


def _u01(keys, ticks, salt: np.uint64) -> np.ndarray:
    """Uniform [0, 1) float64 draws (53 mantissa bits of the hash)."""
    return (_counter_hash(keys, ticks, salt) >> np.uint64(11)).astype(
        np.float64) * _U53


def _std_normal(keys, ticks) -> np.ndarray:
    """Standard-normal draws via Box-Muller over two salted uniforms."""
    u1 = _u01(keys, ticks, _SALT_FADE_A)
    u2 = _u01(keys, ticks, _SALT_FADE_B)
    # 1 - u1 in (0, 1] keeps the log finite; u1 == 0 maps to z == 0
    return np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)


def _key_of(seed: int) -> np.uint64:
    return np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF)


@dataclass
class ChannelConfig:
    mean_mbps: float = 800.0       # mmWave-grade uplink
    std_mbps: float = 350.0
    corr: float = 0.95             # AR(1) coefficient per tick
    blockage_prob: float = 0.03    # P(LoS -> NLoS) per tick
    recovery_prob: float = 0.25    # P(NLoS -> LoS) per tick
    nlos_factor: float = 0.08      # capacity multiplier when blocked
    min_mbps: float = 5.0
    tick_seconds: float = 0.1
    seed: int = 0


class Channel:
    """Stateful simulated link; ``step()`` advances one tick and returns the
    current capacity in bytes/second.

    ``cfg`` defaults to a *fresh* ``ChannelConfig`` per instance — a shared
    default-argument instance would alias the (mutable) config across every
    default-constructed channel.

    Draws are counter-based (see module docstring): tick ``t``'s innovation
    and blockage uniforms are pure hashes of ``(seed, t)``, so N scalar
    channels and one :class:`FleetChannel` over the same seeds realize
    bit-identical capacity sequences.
    """

    #: duck-typed mobility marker (see :func:`is_mobile`)
    mobile = False

    def __init__(self, cfg: Optional[ChannelConfig] = None):
        self.cfg = cfg if cfg is not None else ChannelConfig()
        self._key = _key_of(self.cfg.seed)
        self._tick = 0             # counter-RNG tick index
        self._x = 0.0              # AR(1) state (zero-mean)
        self.blocked = False
        self.t = 0.0

    def step(self) -> float:
        """Advance the live channel state by ONE tick (AR(1) fade + blockage
        Markov chain) and return the new capacity in bytes/second. Every call
        mutates ``self`` — replaying a tick is not possible; reconstruct the
        channel from the same config/seed instead."""
        c = self.cfg
        z = float(_std_normal(self._key, self._tick)[0])
        u = float(_u01(self._key, self._tick, _SALT_BLOCK)[0])
        self._tick += 1
        self._x = c.corr * self._x + \
            np.sqrt(1 - c.corr ** 2) * c.std_mbps * z
        if self.blocked:
            if u < c.recovery_prob:
                self.blocked = False
        else:
            if u < c.blockage_prob:
                self.blocked = True
        mbps = max(c.mean_mbps + self._x, c.min_mbps)
        if self.blocked:
            mbps = max(mbps * c.nlos_factor, c.min_mbps)
        self.t += c.tick_seconds
        return mbps * 1e6 / 8.0    # bytes/s

    def trace(self, n_ticks: int) -> np.ndarray:
        """Capacities (bytes/s) for the next ``n_ticks`` ticks.

        This ADVANCES the live channel state (it calls :meth:`step`
        ``n_ticks`` times): after ``trace(n)`` the channel sits ``n`` ticks
        later, and interleaving ``trace`` with ``step`` continues the same
        realization. For a side-effect-free preview, build a second
        ``Channel`` from the same config (same seed) and trace that."""
        return np.array([self.step() for _ in range(n_ticks)])


class TraceChannel(Channel):
    """A link that replays a prescribed capacity trace (bytes/s per tick).

    Deterministic by construction — both sides of an A/B policy comparison
    (e.g. adaptive vs admission-frozen mode selection in
    ``repro_torch/benchmarks/bench_serving.py``) see the *identical*
    capacity sequence.
    After the trace is exhausted, ``step`` holds the last value, or cycles
    from the start when ``cycle=True``.
    """

    def __init__(self, capacities_bps: Sequence[float], *,
                 cycle: bool = False, cfg: Optional[ChannelConfig] = None):
        super().__init__(cfg)
        self.capacities = np.asarray(capacities_bps, np.float64)
        if self.capacities.size == 0:
            raise ValueError("TraceChannel needs a non-empty trace")
        self.cycle = cycle
        self._i = 0

    def step(self) -> float:
        """Advance the live replay cursor one tick and return that tick's
        scripted capacity in bytes/second (mutates ``self`` like
        ``Channel.step``)."""
        n = self.capacities.size
        i = self._i % n if self.cycle else min(self._i, n - 1)
        self._i += 1
        self.t += self.cfg.tick_seconds
        return float(self.capacities[i])


class MobilityChannel(Channel):
    """A UE that moves *between cells* while its session is live.

    ``cells`` scripts which physical cell the UE sits in at each channel
    tick (hold-last after the script ends, or cycle); ``cell_caps_bps``
    gives each cell's uplink capacity when the UE is served *by that cell's
    edge replica*. The serving side is explicit: :class:`EdgeCluster` (or
    any caller) sets :attr:`serving_cell` at admission and again when a
    migration lands. Whenever the UE's physical cell differs from its
    serving cell — it crossed a cell boundary but its session still lives
    on the old edge server — the returned capacity is multiplied by
    ``detach_factor`` (inter-cell backhaul detour / degraded beam), which
    is exactly the "stay-and-degrade" cost a handover policy weighs against
    migrating the decode state.

    Crossings are *events*: ``step()`` records each boundary crossing in
    ``handover_ticks`` and leaves the new cell id in ``pending_handover``
    until the serving side acknowledges it (``ack_handover``). Handover
    latency is measured in channel ticks: crossing tick -> the tick at
    which ``serving_cell`` matches the physical cell again
    (``handover_latencies``).

    Deterministic by construction, like :class:`TraceChannel` — both sides
    of a migrate-vs-stay A/B replay the identical cell-crossing script.
    """

    mobile = True

    def __init__(self, cells: Sequence[int], cell_caps_bps: Sequence[float],
                 *, detach_factor: float = 0.05, cycle: bool = False,
                 cfg: Optional[ChannelConfig] = None):
        super().__init__(cfg)
        self.cells = np.asarray(cells, np.int64)
        if self.cells.size == 0:
            raise ValueError("MobilityChannel needs a non-empty cell script")
        self.cell_caps = np.asarray(cell_caps_bps, np.float64)
        if int(self.cells.max()) >= self.cell_caps.size:
            raise ValueError("cell script references a cell with no capacity")
        self.detach_factor = float(detach_factor)
        self.cycle = cycle
        self._i = 0
        self.serving_cell: Optional[int] = None
        self.pending_handover: Optional[int] = None
        self.handover_ticks: list = []       # channel tick of each crossing
        self.handover_latencies: list = []   # ticks from crossing to re-home
        self._crossed_at: Optional[int] = None

    def _cell_at(self, i: int) -> int:
        n = self.cells.size
        return int(self.cells[i % n if self.cycle else min(i, n - 1)])

    @property
    def current_cell(self) -> int:
        """The UE's physical cell at the *next* tick (no state advance) —
        what a placement policy should route against."""
        return self._cell_at(self._i)

    @property
    def last_cell(self) -> int:
        """The physical cell of the most recently *stepped* tick (falls
        back to the script's first cell before any step)."""
        return self._cell_at(max(self._i - 1, 0))

    @property
    def detached(self) -> bool:
        """True when the UE has started transmitting and its last-stepped
        physical cell differs from its serving cell — it is paying
        ``detach_factor`` regardless of whether a crossing *event* is
        still pending (a session placed off-cell at admission is detached
        without ever having crossed)."""
        return (self._i > 0 and self.serving_cell is not None
                and self.last_cell != self.serving_cell)

    def ack_handover(self, serving_cell: int):
        """The serving side re-homed this session (migration landed, or a
        drop-and-replay re-admitted it). Clears the pending event and logs
        the handover latency if the new home matches the physical cell."""
        self.serving_cell = serving_cell
        self.pending_handover = None
        if self._crossed_at is not None and serving_cell == self.last_cell:
            self.handover_latencies.append(self._i - self._crossed_at)
            self._crossed_at = None

    def step(self) -> float:
        """Advance one tick: move the UE along its cell script, flag a
        boundary crossing, and return the capacity the *current serving
        arrangement* delivers (mutates ``self`` like ``Channel.step``)."""
        prev = self._cell_at(max(self._i - 1, 0)) if self._i else None
        cell = self._cell_at(self._i)
        if self.serving_cell is None:        # un-homed: assume co-located
            self.serving_cell = cell
        if prev is not None and cell != prev:
            self.pending_handover = cell
            self.handover_ticks.append(self._i)
            if self._crossed_at is None:
                self._crossed_at = self._i
        self._i += 1
        self.t += self.cfg.tick_seconds
        cap = float(self.cell_caps[cell])
        if cell != self.serving_cell:
            cap = max(cap * self.detach_factor, 1.0)
        return cap


def channel_fleet(n: int, cfg: Optional[ChannelConfig] = None, *,
                  seed: int = 0, mean_spread: float = 0.5) -> list:
    """``n`` independent per-user links for continuous-batching serving.

    Each user gets their own AR(1)/blockage process (distinct sub-seed) and a
    mean uplink drawn log-uniformly within ``[1-mean_spread, 1+mean_spread]``
    of the base config — cell-edge users coexist with beam-center users, so
    a mixed decode batch genuinely wants mixed bottleneck modes.

    Every fleet member owns a *distinct* ``ChannelConfig``
    (``dataclasses.replace`` of the base), and the caller's ``cfg`` is never
    mutated — mutating one member's config cannot leak into another member
    or into later fleets built from the same base.
    """
    base = cfg if cfg is not None else ChannelConfig()
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        scale = float(np.exp(rng.uniform(np.log(max(1 - mean_spread, 0.05)),
                                         np.log(1 + mean_spread))))
        out.append(Channel(dataclasses.replace(
            base,
            mean_mbps=base.mean_mbps * scale,
            std_mbps=base.std_mbps * scale,
            # scale the capacity floor down with the mean, else the floor
            # clamps every cell-edge user to the same capacity
            min_mbps=base.min_mbps * min(scale, 1.0),
            seed=seed * 1_000_003 + i + 1)))
    return out


def is_mobile(ch) -> bool:
    """True when ``ch`` carries the mobility/handover surface (cell script,
    ``serving_cell``, ``pending_handover``, ``ack_handover``) — satisfied by
    :class:`MobilityChannel` AND by a :class:`FleetLane` over a fleet with a
    cell script. The cluster's handover loop dispatches on this instead of
    ``isinstance`` so vectorized fleets ride the same migration machinery."""
    return bool(getattr(ch, "mobile", False))


class FleetLane:
    """One UE's view into a :class:`FleetChannel`.

    Implements the scalar :class:`Channel` protocol (``step``) plus — when
    the fleet has a cell script — the full :class:`MobilityChannel`
    handover surface, WITHOUT owning any simulation state: every attribute
    reads/writes the fleet's arrays. Lanes are what a ``Request.channel``
    carries into the serving engine; the per-fleet capacity math stays
    vectorized underneath (see :meth:`FleetChannel._ensure`).
    """

    __slots__ = ("fleet", "i")

    def __init__(self, fleet: "FleetChannel", i: int):
        self.fleet = fleet
        self.i = int(i)

    # -- the Channel protocol -------------------------------------------------
    @property
    def cfg(self) -> ChannelConfig:
        return self.fleet.cfg

    @property
    def t(self) -> float:
        return float(self.fleet._i[self.i]) * self.fleet.cfg.tick_seconds

    def step(self) -> float:
        return self.fleet._step_lane(self.i)

    def peek(self) -> float:
        """Next tick's capacity under the current serving arrangement,
        WITHOUT advancing the lane — what SLO admission predicts against."""
        return self.fleet._peek_lane(self.i)

    def trace(self, n_ticks: int) -> np.ndarray:
        return np.array([self.step() for _ in range(n_ticks)])

    # -- the MobilityChannel surface (cell-scripted fleets only) --------------
    @property
    def mobile(self) -> bool:
        return self.fleet.cells is not None

    @property
    def cells(self) -> np.ndarray:
        return self.fleet.cells[self.i]

    @property
    def current_cell(self) -> int:
        return self.fleet._cell_at_lane(self.i, int(self.fleet._i[self.i]))

    @property
    def last_cell(self) -> int:
        return self.fleet._cell_at_lane(
            self.i, max(int(self.fleet._i[self.i]) - 1, 0))

    @property
    def serving_cell(self) -> Optional[int]:
        s = int(self.fleet.serving_cell[self.i])
        return None if s < 0 else s

    @serving_cell.setter
    def serving_cell(self, cell: Optional[int]):
        self.fleet.serving_cell[self.i] = -1 if cell is None else int(cell)

    @property
    def pending_handover(self) -> Optional[int]:
        p = int(self.fleet.pending_handover[self.i])
        return None if p < 0 else p

    @pending_handover.setter
    def pending_handover(self, cell: Optional[int]):
        self.fleet.pending_handover[self.i] = -1 if cell is None \
            else int(cell)

    @property
    def detached(self) -> bool:
        f, i = self.fleet, self.i
        return (int(f._i[i]) > 0 and int(f.serving_cell[i]) >= 0
                and self.last_cell != int(f.serving_cell[i]))

    @property
    def handover_ticks(self) -> list:
        return self.fleet.handover_ticks.setdefault(self.i, [])

    @property
    def handover_latencies(self) -> list:
        return self.fleet.handover_latencies.setdefault(self.i, [])

    def ack_handover(self, serving_cell: int):
        self.fleet.ack_handover(self.i, serving_cell)


class FleetChannel:
    """Array-form fleet of UE links: ONE vectorized numpy step advances
    capacity, cell membership, and detach state for every UE.

    The scalar classes are the ORACLE — a seeded fleet realizes
    bit-identical trajectories to ``n`` independent scalar channels,
    because both sides draw through the same counter-based RNG (pure hash
    of ``(per-UE key, tick)``) — but the
    fleet holds its state as ``[n]`` arrays and computes capacities in
    vectorized time chunks, so a 10k-UE city simulation costs a handful of
    numpy ops per tick instead of 10k Python object steps.

    Three capacity sources (mutually exclusive):

    fade (default)
        Per-UE AR(1)/blockage processes matching :func:`channel_fleet`
        exactly: same per-UE seeds (``seed * 1_000_003 + i + 1``), same
        log-uniform mean spread, same ``ChannelConfig`` dynamics.
    ``traces_bps`` ``[n, T]``
        Per-UE scripted replay (:class:`TraceChannel` semantics:
        hold-last, or ``cycle=True``) — e.g. Lumos5G real-trace capacities
        from :func:`repro_torch.data.lumos5g.capacity_traces_bps`.
    ``cell_caps_bps`` with ``cells``
        Per-cell capacities (:class:`MobilityChannel` semantics).

    ``cells`` ``[n, T]`` adds mobility on top of ``traces_bps`` OR
    ``cell_caps_bps``: per-tick cell membership, crossing events,
    ``detach_factor`` throttling while a session is served off-cell, and
    the ``ack_handover`` latency bookkeeping the cluster's migration loop
    drives. ``traces_bps + cells`` is the city-replay mode (real-trace
    capacity, scripted cell crossings) that has no scalar equivalent.

    Lanes advance independently (each serving slot steps its own UE's
    channel), so the fleet keeps per-UE cursors; fade capacities are
    computed for ALL UEs in vectorized chunks up to the furthest cursor and
    memoized, which is what keeps per-lane ``step()`` O(1).
    """

    def __init__(self, n: int, cfg: Optional[ChannelConfig] = None, *,
                 seed: int = 0, mean_spread: float = 0.5,
                 traces_bps: Optional[np.ndarray] = None,
                 cells: Optional[np.ndarray] = None,
                 cell_caps_bps: Optional[Sequence[float]] = None,
                 detach_factor: float = 0.05, cycle: bool = False):
        if n < 1:
            raise ValueError("FleetChannel needs at least one UE")
        if traces_bps is not None and cell_caps_bps is not None:
            raise ValueError("traces_bps and cell_caps_bps are exclusive "
                             "capacity sources")
        if cell_caps_bps is not None and cells is None:
            raise ValueError("cell_caps_bps needs a cell script")
        self.n = int(n)
        self.cfg = cfg if cfg is not None else ChannelConfig()
        self.cycle = bool(cycle)
        self.detach_factor = float(detach_factor)
        self._i = np.zeros(self.n, np.int64)           # per-lane cursors

        self.traces = None
        if traces_bps is not None:
            self.traces = np.asarray(traces_bps, np.float64)
            if self.traces.ndim != 2 or self.traces.shape[0] != self.n:
                raise ValueError(
                    f"traces_bps must be [n={self.n}, T], got "
                    f"{self.traces.shape}")
            if self.traces.shape[1] == 0:
                raise ValueError("traces_bps needs a non-empty trace")

        self.cells = None
        self.cell_caps = None
        if cells is not None:
            self.cells = np.asarray(cells, np.int64)
            if self.cells.ndim != 2 or self.cells.shape[0] != self.n or \
                    self.cells.shape[1] == 0:
                raise ValueError(
                    f"cells must be a non-empty [n={self.n}, T] script, "
                    f"got {self.cells.shape}")
            if cell_caps_bps is not None:
                self.cell_caps = np.asarray(cell_caps_bps, np.float64)
                if int(self.cells.max()) >= self.cell_caps.size:
                    raise ValueError(
                        "cell script references a cell with no capacity")
            self.serving_cell = np.full(self.n, -1, np.int64)
            self.pending_handover = np.full(self.n, -1, np.int64)
            self._crossed_at = np.full(self.n, -1, np.int64)
            #: sparse per-UE event logs (only crossings allocate entries)
            self.handover_ticks: Dict[int, list] = {}
            self.handover_latencies: Dict[int, list] = {}

        if self.traces is None and self.cell_caps is None:
            # fade mode: replicate channel_fleet's per-member calibration
            # exactly (same numpy Generator draws — a size-n uniform equals
            # n sequential scalar uniforms), so fleet lane i is the same
            # link as channel_fleet(n, cfg, seed=seed)[i]
            base = self.cfg
            rng = np.random.default_rng(seed)
            scale = np.exp(rng.uniform(
                np.log(max(1 - mean_spread, 0.05)),
                np.log(1 + mean_spread), self.n))
            self._mean = base.mean_mbps * scale
            self._min = base.min_mbps * np.minimum(scale, 1.0)
            # the AR(1) innovation coefficient, associated exactly like the
            # scalar step: (sqrt(1-corr^2) * std) * z
            self._coef = np.sqrt(1 - base.corr ** 2) * (base.std_mbps
                                                        * scale)
            self.keys = np.array(
                [_key_of(seed * 1_000_003 + i + 1) for i in range(self.n)],
                np.uint64)
            self._x = np.zeros(self.n, np.float64)
            self.blocked = np.zeros(self.n, bool)
            self._frontier = 0                 # fade ticks computed so far
            self._cap = np.zeros((self.n, 0), np.float64)

        self._lanes: Dict[int, FleetLane] = {}

    # -- index math -----------------------------------------------------------
    def _script_idx(self, t, size: int):
        t = np.asarray(t, np.int64)
        return t % size if self.cycle else np.minimum(t, size - 1)

    def _cell_at(self, t) -> np.ndarray:
        """[k] physical cells at per-UE ticks ``t`` (full-fleet callers
        pass all rows; the script holds-last / cycles like the scalar)."""
        idx = self._script_idx(t, self.cells.shape[1])
        return self.cells[np.arange(len(idx)), idx]

    def _cell_at_lane(self, i: int, t: int) -> int:
        idx = int(self._script_idx(t, self.cells.shape[1]))
        return int(self.cells[i, idx])

    # -- fade-mode chunked computation ---------------------------------------
    def _ensure(self, tmax: int):
        """Materialize fade capacities for ticks ``[_frontier, tmax]`` for
        the WHOLE fleet in one vectorized time loop — per-lane reads then
        index the memo. The recurrence is the scalar ``Channel.step``
        verbatim, over ``[n]`` arrays."""
        if tmax < self._frontier:
            return
        if tmax >= self._cap.shape[1]:
            grow = max(tmax + 1, 2 * max(self._cap.shape[1], 16))
            cap = np.zeros((self.n, grow), np.float64)
            cap[:, :self._cap.shape[1]] = self._cap
            self._cap = cap
        c = self.cfg
        x, blocked = self._x, self.blocked
        for t in range(self._frontier, tmax + 1):
            z = _std_normal(self.keys, t)
            u = _u01(self.keys, t, _SALT_BLOCK)
            x = c.corr * x + self._coef * z
            blocked = np.where(blocked, u >= c.recovery_prob,
                               u < c.blockage_prob)
            mbps = np.maximum(self._mean + x, self._min)
            mbps = np.where(blocked,
                            np.maximum(mbps * c.nlos_factor, self._min),
                            mbps)
            self._cap[:, t] = mbps * 1e6 / 8.0
        self._x, self.blocked = x, blocked
        self._frontier = tmax + 1

    def _base_caps(self, idx: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Capacity (bytes/s) of UEs ``idx`` at their ticks ``t``, BEFORE
        any mobility detach throttling."""
        if self.traces is not None:
            return self.traces[idx, self._script_idx(t,
                                                     self.traces.shape[1])]
        if self.cell_caps is not None:
            ci = self._script_idx(t, self.cells.shape[1])
            return self.cell_caps[self.cells[idx, ci]]
        self._ensure(int(t.max()))
        return self._cap[idx, t]

    # -- stepping -------------------------------------------------------------
    def _advance(self, idx: np.ndarray) -> np.ndarray:
        """Advance UEs ``idx`` one tick each (vectorized): mobility
        bookkeeping mirrors ``MobilityChannel.step`` exactly, then the
        cursors move. Returns delivered capacities [len(idx)] bytes/s."""
        t = self._i[idx]
        caps = self._base_caps(idx, t)
        if self.cells is not None:
            ci = self._script_idx(t, self.cells.shape[1])
            cell = self.cells[idx, ci]
            pi = self._script_idx(np.maximum(t - 1, 0),
                                  self.cells.shape[1])
            prev = self.cells[idx, pi]
            unhomed = self.serving_cell[idx] < 0
            if unhomed.any():
                u = idx[unhomed]
                self.serving_cell[u] = cell[unhomed]
            crossed = (t > 0) & (cell != prev)
            if crossed.any():
                c_idx = idx[crossed]
                self.pending_handover[c_idx] = cell[crossed]
                for j, tick in zip(c_idx, t[crossed]):
                    self.handover_ticks.setdefault(int(j), []).append(
                        int(tick))
                fresh = crossed & (self._crossed_at[idx] < 0)
                self._crossed_at[idx[fresh]] = t[fresh]
            det = cell != self.serving_cell[idx]
            caps = np.where(det,
                            np.maximum(caps * self.detach_factor, 1.0),
                            caps)
        self._i[idx] = t + 1
        return caps

    def step_all(self) -> np.ndarray:
        """ONE vectorized step for the whole fleet: every lane advances a
        tick; returns the delivered capacities ``[n]`` in bytes/second."""
        return self._advance(np.arange(self.n))

    def _step_lane(self, i: int) -> float:
        return float(self._advance(np.array([i]))[0])

    def _peek_lane(self, i: int) -> float:
        """Pure preview of lane ``i``'s next delivered capacity (no cursor
        advance, no event bookkeeping) — un-homed UEs are assumed
        co-located, exactly like the scalar's first step."""
        idx = np.array([i])
        t = self._i[idx]
        cap = float(self._base_caps(idx, t)[0])
        if self.cells is not None:
            cell = self._cell_at_lane(i, int(t[0]))
            serving = int(self.serving_cell[i])
            if serving >= 0 and cell != serving:
                cap = max(cap * self.detach_factor, 1.0)
        return cap

    def peek_all(self) -> np.ndarray:
        """Vectorized :meth:`FleetLane.peek` for the whole fleet — the SLO
        admission controller's batch prediction input."""
        t = self._i
        caps = self._base_caps(np.arange(self.n), t)
        if self.cells is not None:
            cell = self._cell_at(t)
            det = (self.serving_cell >= 0) & (cell != self.serving_cell)
            caps = np.where(det,
                            np.maximum(caps * self.detach_factor, 1.0),
                            caps)
        return caps

    def ack_handover(self, i: int, serving_cell: int):
        """Lane ``i``'s serving side re-homed it (MobilityChannel
        semantics: clears the pending event, logs crossing->re-home
        latency in ticks when the new home matches the physical cell)."""
        self.serving_cell[i] = int(serving_cell)
        self.pending_handover[i] = -1
        if self._crossed_at[i] >= 0 and \
                int(serving_cell) == self._cell_at_lane(
                    i, max(int(self._i[i]) - 1, 0)):
            self.handover_latencies.setdefault(int(i), []).append(
                int(self._i[i] - self._crossed_at[i]))
            self._crossed_at[i] = -1

    def lane(self, i: int) -> FleetLane:
        """The per-UE :class:`Channel`-protocol view serving requests
        carry (cached — one lane object per UE, ever)."""
        if not 0 <= i < self.n:
            raise IndexError(f"lane {i} out of range [0, {self.n})")
        ln = self._lanes.get(i)
        if ln is None:
            ln = self._lanes[i] = FleetLane(self, i)
        return ln

    def lanes(self) -> List[FleetLane]:
        return [self.lane(i) for i in range(self.n)]


def city_grid_cells(n: int, n_ticks: int, n_cells: int, *, seed: int = 0,
                    dwell_ticks: int = 64) -> np.ndarray:
    """Scripted city grid: ``[n, n_ticks]`` cell membership for ``n`` UEs
    random-walking a ring of ``n_cells`` cells (the Lumos5G downtown loop
    topology — each cell fronts one edge replica). Each UE starts in a
    random cell and crosses to a neighbour with probability
    ``1 / dwell_ticks`` per tick; fully vectorized, deterministic per seed.
    """
    if n_cells < 1:
        raise ValueError("need at least one cell")
    rng = np.random.default_rng(seed)
    start = rng.integers(0, n_cells, size=n)
    if n_cells == 1:
        return np.zeros((n, n_ticks), np.int64) + start[:, None]
    move = rng.random((n, n_ticks)) < 1.0 / max(int(dwell_ticks), 1)
    step = rng.integers(0, 2, size=(n, n_ticks)) * 2 - 1
    step = np.where(move, step, 0)
    step[:, 0] = 0                      # tick 0 is the starting cell
    return (start[:, None] + np.cumsum(step, axis=1)) % n_cells


def tx_seconds(payload_bytes: int, capacity_bps: float,
               rtt_seconds: float = RTT_SECONDS) -> float:
    """Transfer latency for one boundary payload."""
    return payload_bytes / max(capacity_bps, 1.0) + rtt_seconds
