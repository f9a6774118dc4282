"""Per-slot, per-tick bottleneck mode controller for the continuous engine,
and the replica autoscaler (a copy of ``repro.serving.controller``).

The paper's central claim is *dynamic* encoding/decoding: the encoder's
transmit mode must track the channel as it changes, not just at admission.
The continuous engine already decodes any per-slot mode mixture in one
step (``split_decode_step_mixed`` gathers each slot's head from the
stacked bank), so re-selecting a live session's mode costs **no retrace** —
what was missing is the control loop. ``ModeController`` closes it:

* every decode tick it feeds each live session's own ``Channel`` observation
  into the shared :class:`~repro_torch.core.orchestrator.Orchestrator` (per-link
  EWMA capacity tracking) and re-selects that session's bottleneck mode via
  the vectorized ``Orchestrator.choose_modes`` — one numpy broadcast over
  the whole pool, not N Python feasibility scans;
* **dwell time**: after a switch, a session's mode is held for
  ``dwell_ticks`` engine ticks, on top of the orchestrator's capacity
  hysteresis, so a link oscillating around a feasibility boundary cannot
  flap between modes every tick;
* **deadline-aware escalation**: the controller tracks an EWMA of each
  session's per-token transfer-time utilization (predicted transfer latency
  of the chosen mode / the session's ``AppRequirement.latency_budget_s``).
  When utilization crosses ``escalate_util`` the session is dropped to the
  cheapest calibrated mode *immediately*, bypassing dwell and hysteresis —
  a degrading mmWave link must never ride an 8-bit payload through its
  latency budget just because the dwell timer says wait.

The engine (``repro_torch.serving.batcher``) records the resulting per-session
mode-switch traces and deadline misses in ``Session``/``stats()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.channel import tx_seconds
from repro_torch.core.orchestrator import AppRequirement, Orchestrator


@dataclass
class ControllerConfig:
    """Knobs for the per-tick mode control loop (the orchestrator's EWMA
    weight and capacity hysteresis are configured on the orchestrator)."""
    dwell_ticks: int = 2        # min ticks between voluntary mode switches
    escalate_util: float = 1.0  # transfer/budget EWMA ratio that triggers
    #                             escalation to the cheapest mode
    util_ema: float = 0.5       # EWMA weight for the utilization tracker


@dataclass
class SlotControl:
    """Per-session controller state (lives from admission to retirement)."""
    mode: int = 0
    last_switch_tick: int = -(1 << 30)
    util_ema: float = 0.0
    ticks: int = 0              # decode ticks this session has been steered
    switches: int = 0
    escalations: int = 0
    #: (engine_tick, from_mode, to_mode) per switch, admission entry included
    trace: List[Tuple[int, int, int]] = field(default_factory=list)


class ModeController:
    """Drives per-slot, per-tick mode re-selection for live sessions.

    Wraps a shared :class:`Orchestrator` (mode calibration and per-link
    EWMAs live there) and adds the serving-side control policy: dwell-time
    suppression and deadline-aware escalation. One controller serves one
    engine; sessions attach at admission and detach at retirement.
    """

    def __init__(self, orchestrator: Orchestrator,
                 cfg: Optional[ControllerConfig] = None):
        self.orch = orchestrator
        self.cfg = cfg if cfg is not None else ControllerConfig()
        self._ctl: Dict[Hashable, SlotControl] = {}
        self._cheapest = min(orchestrator.profiles,
                             key=lambda p: p.payload_bytes).mode
        self._payload = {p.mode: p.payload_bytes
                         for p in orchestrator.profiles}
        #: optional observer ``(rid, tick, from_mode, to_mode) -> None``
        #: fired on every deadline escalation (telemetry engines attach a
        #: trace-event emitter here; None costs nothing)
        self.on_escalate = None

    # -- session lifecycle ----------------------------------------------------
    def admit(self, rid: Hashable, requirement: Optional[AppRequirement],
              capacity_bps: Optional[float], tick: int) -> int:
        """Admission-time selection: register the link, feed the first
        capacity observation, choose the initial mode. Returns the mode."""
        self.orch.register(rid, requirement)
        if capacity_bps is not None:
            self.orch.observe_capacity(capacity_bps, rid=rid)
        mode = self.orch.choose_mode(rid=rid)
        self._ctl[rid] = SlotControl(mode=mode, last_switch_tick=tick,
                                     trace=[(tick, mode, mode)])
        return mode

    def finish(self, rid: Hashable) -> Optional[SlotControl]:
        """Release the session's link state; returns its control record so
        the engine can fold the switch trace into the ``Session``."""
        self.orch.release(rid)
        return self._ctl.pop(rid, None)

    def detach(self, rid: Hashable) -> Optional[SlotControl]:
        """Remove and return the session's control record WITHOUT touching
        the orchestrator (the caller detaches that separately) — the
        live-migration export: dwell timer, utilization EWMA, and switch
        trace travel with the session to the target controller."""
        return self._ctl.pop(rid, None)

    def attach(self, rid: Hashable, ctl: Optional[SlotControl]) -> None:
        """Install a control record exported by :meth:`detach`."""
        if ctl is not None:
            self._ctl[rid] = ctl

    # -- the per-tick control loop --------------------------------------------
    def step_modes(self, rids: Sequence[Hashable],
                   capacities: Sequence[Optional[float]],
                   tick: int) -> np.ndarray:
        """Re-select every live session's mode for this engine tick.

        ``rids``/``capacities`` are aligned (capacity ``None`` = no fresh
        observation for that link this tick). Returns ``int32 [N]`` modes.
        """
        if not len(rids):
            return np.zeros(0, np.int32)
        ctls = [self._ctl.setdefault(r, SlotControl()) for r in rids]
        hold = np.array([tick - c.last_switch_tick < self.cfg.dwell_ticks
                         for c in ctls])
        # uncommitted pass: the policy's pick, which escalation may still
        # override — each link's FINAL mode commits exactly once below
        chosen = self.orch.choose_modes(rids, capacities, hold=hold,
                                        commit=False)

        for i, (rid, ctl) in enumerate(zip(rids, ctls)):
            link = self.orch.register(rid)
            req = self.orch.requirement_for(rid)
            mode = int(chosen[i])
            if link.ticks > 0:
                # deadline tracker: predicted transfer time of the mode we
                # are about to use, as a fraction of this session's latency
                # budget (the same tx_seconds the engine's accounting uses).
                # Cold links (no capacity observed yet) are skipped entirely
                # — the EMA is a phantom 0.0 there and utilization would
                # explode; choose_modes is documented to stay optimistic on
                # cold start, so the escalation tracker stays out of it too.
                tx = tx_seconds(self._payload[mode], link.capacity_ema)
                util = tx / max(req.latency_budget_s, 1e-9)
                w = self.cfg.util_ema
                ctl.util_ema = (util if ctl.ticks == 0
                                else w * ctl.util_ema + (1 - w) * util)
                ctl.ticks += 1
            if (ctl.ticks > 0 and ctl.util_ema > self.cfg.escalate_util
                    and mode != self._cheapest):
                # budget at risk: drop to the cheapest calibrated mode NOW,
                # overriding dwell/hysteresis (they exist to damp flapping,
                # not to ride a collapsing link into a deadline miss)
                if self.on_escalate is not None:
                    self.on_escalate(rid, tick, int(chosen[i]), self._cheapest)
                mode = self._cheapest
                ctl.escalations += 1
            self.orch.force_mode(rid, mode)   # single commit point: one
            #                                   counted switch per transition
            if mode != ctl.mode:
                ctl.trace.append((tick, ctl.mode, mode))
                ctl.mode = mode
                ctl.switches += 1
                ctl.last_switch_tick = tick
            chosen[i] = mode
        return chosen

    # -- introspection --------------------------------------------------------
    def control(self, rid: Hashable) -> Optional[SlotControl]:
        return self._ctl.get(rid)

    @property
    def n_attached(self) -> int:
        return len(self._ctl)


# ---------------------------------------------------------------------------
# replica autoscaling (fleet-scale elasticity)
# ---------------------------------------------------------------------------

@dataclass
class AutoscalerConfig:
    """Thresholds for SLO-driven replica elasticity.

    Pressure (any of): smoothed slot occupancy above ``high_occupancy``,
    queue backlog above ``queue_per_slot_high`` waiting requests per
    aggregate slot, or the recent session-SLO miss rate above
    ``miss_rate_high``. Relaxation (all of): occupancy below
    ``low_occupancy`` with an empty backlog and no recent misses. Either
    condition must hold for ``sustain_ticks`` consecutive observations to
    fire, and after any decision the scaler sleeps ``cooldown_ticks`` so
    capacity changes settle before the signals are trusted again.
    """
    min_replicas: int = 1
    max_replicas: int = 8
    high_occupancy: float = 0.85
    low_occupancy: float = 0.30
    queue_per_slot_high: float = 1.0
    miss_rate_high: float = 0.05
    sustain_ticks: int = 3
    cooldown_ticks: int = 8
    ema: float = 0.5                 # occupancy smoothing weight (on history)


class Autoscaler:
    """Pure-signal replica-count controller.

    ``observe`` consumes one cluster-step observation and returns the
    decision for this tick: ``+1`` (add a replica), ``-1`` (retire one),
    or ``0``. It never touches the cluster itself — ``EdgeCluster.step``
    applies the decision — so decisions are a deterministic function of
    the observation sequence and unit-testable without any engine.
    """

    def __init__(self, cfg: Optional[AutoscalerConfig] = None):
        self.cfg = cfg if cfg is not None else AutoscalerConfig()
        if self.cfg.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.cfg.max_replicas < self.cfg.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.occ_ema = 0.0
        self.ticks = 0
        self._hi = 0                 # consecutive pressure observations
        self._lo = 0                 # consecutive relaxation observations
        self._cooldown = 0
        #: (tick_index, decision, reason) per nonzero decision
        self.events: List[Tuple[int, int, str]] = []

    def observe(self, *, n_replicas: int, occupancy: float,
                queue_per_slot: float = 0.0,
                miss_rate: float = 0.0) -> int:
        """One observation -> -1/0/+1. ``occupancy`` is the live-replica
        mean busy-slot fraction for the step, ``queue_per_slot`` the
        waiting requests per aggregate slot, ``miss_rate`` the recent
        session-SLO miss fraction."""
        w = self.cfg.ema
        self.occ_ema = (occupancy if self.ticks == 0
                        else w * self.occ_ema + (1 - w) * occupancy)
        self.ticks += 1
        pressure = (self.occ_ema > self.cfg.high_occupancy
                    or queue_per_slot > self.cfg.queue_per_slot_high
                    or miss_rate > self.cfg.miss_rate_high)
        relaxed = (self.occ_ema < self.cfg.low_occupancy
                   and queue_per_slot <= 0.0
                   and miss_rate <= 0.0)
        self._hi = self._hi + 1 if pressure else 0
        self._lo = self._lo + 1 if relaxed else 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        if self._hi >= self.cfg.sustain_ticks \
                and n_replicas < self.cfg.max_replicas:
            self._hi = self._lo = 0
            self._cooldown = self.cfg.cooldown_ticks
            reason = ("occupancy" if self.occ_ema > self.cfg.high_occupancy
                      else "queue" if queue_per_slot
                      > self.cfg.queue_per_slot_high else "miss_rate")
            self.events.append((self.ticks - 1, +1, reason))
            return +1
        if self._lo >= self.cfg.sustain_ticks \
                and n_replicas > self.cfg.min_replicas:
            self._hi = self._lo = 0
            self._cooldown = self.cfg.cooldown_ticks
            self.events.append((self.ticks - 1, -1, "idle"))
            return -1
        return 0
