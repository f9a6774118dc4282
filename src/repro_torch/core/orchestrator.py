"""A copy of ``repro.core.orchestrator``. The paper's orchestrator
(Fig. 3): monitors network conditions + decoder performance feedback and
instructs the encoder which latent code to transmit.

Policy: among the calibrated modes, pick the most relevant (lowest expected
loss) whose transfer latency fits the application's budget, with hysteresis
to avoid mode flapping. This is the "optimization/search problem" framing the
paper suggests in Sec. VI.

Two usage levels:

* **Shared link** (the original API): ``observe_capacity(bps)`` +
  ``choose_mode()`` track one EMA'd capacity for the whole deployment —
  fine when every request rides the same simulated channel.
* **Per-request links** (continuous-batching serving): each in-flight
  request has its *own* mmWave link, so the orchestrator keeps one
  ``LinkState`` per request id — ``register(rid)``, then
  ``observe_capacity(bps, rid=rid)`` / ``choose_mode(rid=rid)`` /
  ``release(rid)``. Mode-relevance feedback (``observe_decoder_loss``)
  stays shared: decoder quality per mode is a property of the calibrated
  cascade, not of any one user's channel.

Cold start: before the first capacity observation the link quality is
*unknown*, not zero — ``choose_mode`` is optimistic and picks the most
relevant mode meeting the accuracy floor instead of silently deeming every
mode infeasible and pinning the smallest payload.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.channel import RTT_SECONDS, tx_seconds


@dataclass
class ModeProfile:
    """Calibration entry per mode (from cascade validation)."""
    mode: int
    payload_bytes: int        # per-query boundary payload
    expected_loss: float      # validation loss of this mode
    expected_acc: float = 0.0


@dataclass
class AppRequirement:
    latency_budget_s: float = 0.05   # per-query transfer budget
    min_acc: float = 0.0             # slice-dependent floor (0 = best effort)


@dataclass
class LinkState:
    """Per-link (per-request, or shared-legacy) orchestration state."""
    mode: int = 0
    capacity_ema: float = 0.0
    switches: int = 0
    ticks: int = 0


@dataclass
class OrchestratorState(LinkState):
    """Legacy shared state; ``loss_ema`` aliases the orchestrator-wide
    relevance feedback so existing callers keep working."""
    loss_ema: Dict[int, float] = field(default_factory=dict)


class Orchestrator:
    def __init__(self, profiles: List[ModeProfile],
                 requirement: Optional[AppRequirement] = None,
                 *, ema: float = 0.8, hysteresis: float = 0.85):
        if not profiles:
            raise ValueError("need at least one mode profile")
        self.profiles = sorted(profiles, key=lambda p: p.mode)
        # a fresh instance per orchestrator: a dataclass default instance
        # would be shared (and mutated) across constructions
        self.req = (dataclasses.replace(requirement) if requirement is not None
                    else AppRequirement())
        self.ema = ema
        self.hysteresis = hysteresis
        self.state = OrchestratorState(
            mode=self.profiles[0].mode,
            loss_ema={p.mode: p.expected_loss for p in self.profiles})
        self.loss_ema = self.state.loss_ema      # shared relevance feedback
        self._links: Dict[Hashable, LinkState] = {}
        self._reqs: Dict[Hashable, AppRequirement] = {}

    # -- per-request lifecycle ------------------------------------------------
    def register(self, rid: Hashable,
                 requirement: Optional[AppRequirement] = None) -> LinkState:
        """Start tracking a request's own link (idempotent)."""
        if rid not in self._links:
            self._links[rid] = LinkState(mode=self.profiles[0].mode)
            if requirement is not None:
                self._reqs[rid] = dataclasses.replace(requirement)
        return self._links[rid]

    def release(self, rid: Hashable) -> None:
        self._links.pop(rid, None)
        self._reqs.pop(rid, None)

    def detach(self, rid: Hashable) -> Tuple[Optional[LinkState],
                                             Optional[AppRequirement]]:
        """Remove and RETURN a link's orchestration state instead of
        discarding it — the live-migration export: the capacity EWMA and
        requirement travel with the session to another orchestrator's
        :meth:`attach` so mode selection continues across the handover."""
        return self._links.pop(rid, None), self._reqs.pop(rid, None)

    def attach(self, rid: Hashable, link: Optional[LinkState],
               requirement: Optional[AppRequirement] = None) -> None:
        """Install a link state exported by :meth:`detach` (live-migration
        import). A ``None`` link leaves any existing registration alone."""
        if link is not None:
            self._links[rid] = link
        if requirement is not None:
            self._reqs[rid] = requirement

    def _link(self, rid: Optional[Hashable]) -> LinkState:
        if rid is None:
            return self.state
        return self.register(rid)

    def _req(self, rid: Optional[Hashable]) -> AppRequirement:
        if rid is None:
            return self.req
        return self._reqs.get(rid, self.req)

    # -- feedback signals (Fig. 3 arrows) ------------------------------------
    def observe_capacity(self, capacity_bps: float,
                         rid: Optional[Hashable] = None):
        s = self._link(rid)
        s.capacity_ema = (self.ema * s.capacity_ema
                          + (1 - self.ema) * capacity_bps
                          if s.ticks else capacity_bps)
        s.ticks += 1

    def observe_decoder_loss(self, mode: int, loss: float):
        prev = self.loss_ema.get(mode, loss)
        self.loss_ema[mode] = self.ema * prev + (1 - self.ema) * loss

    # -- decision -------------------------------------------------------------
    def feasible(self, p: ModeProfile, capacity_bps: float,
                 req: Optional[AppRequirement] = None) -> bool:
        req = req if req is not None else self.req
        return tx_seconds(p.payload_bytes, capacity_bps) \
            <= req.latency_budget_s

    def choose_mode(self, rid: Optional[Hashable] = None) -> int:
        s = self._link(rid)
        req = self._req(rid)
        cap = s.capacity_ema
        # rank by relevance (EMA loss asc); most informative feasible wins
        ranked = sorted(self.profiles, key=lambda p: self.loss_ema[p.mode])
        chosen: Optional[ModeProfile] = None
        for p in ranked:
            if req.min_acc and p.expected_acc < req.min_acc:
                continue
            # cold start: no capacity observed yet -> optimistic (the first
            # observation will correct us next tick); never pin the smallest
            # payload off a phantom zero-capacity reading
            if s.ticks == 0 or self.feasible(p, cap, req):
                chosen = p
                break
        if chosen is None:           # nothing fits: smallest payload
            chosen = min(self.profiles, key=lambda p: p.payload_bytes)
        # hysteresis: only leave the current mode if the alternative's
        # required capacity clears by a margin
        cur = next(p for p in self.profiles if p.mode == s.mode)
        if s.ticks and chosen.mode != cur.mode \
                and chosen.payload_bytes > cur.payload_bytes:
            if not self.feasible(chosen, cap * self.hysteresis, req):
                chosen = cur
        if chosen.mode != s.mode:
            s.switches += 1
            s.mode = chosen.mode
        return s.mode

    # -- vectorized per-tick decision (continuous-batching hot path) ----------
    def choose_modes(self, rids: Sequence[Hashable],
                     capacities: Optional[Sequence[Optional[float]]] = None,
                     hold: Optional[Sequence[bool]] = None,
                     commit: bool = True) -> np.ndarray:
        """Per-link mode selection for a whole decode batch in one shot.

        Numerically identical to calling ``observe_capacity(c, rid=r)`` +
        ``choose_mode(rid=r)`` per link, but the O(N x M) feasibility scan
        (every link against every mode profile) is one numpy broadcast
        instead of N Python loops — this is what the serving-side
        ``ModeController`` calls every engine tick.

        ``capacities``: optional per-link observation (``None`` entries skip
        the EMA update for that link). ``hold``: optional boolean mask —
        links with ``hold[i]`` keep their current mode this tick (their EMA
        still updates); the controller uses it for dwell-time suppression.
        Returns the chosen mode per link as ``int32 [N]``; with ``commit``
        (the default) each link's ``LinkState`` (mode, switch count) updates
        exactly as the scalar path does. ``commit=False`` leaves the link
        states untouched so a caller that may still override the choice
        (the controller's deadline escalation) can commit the FINAL mode
        once via :meth:`force_mode` — one counted switch per observable
        transition.
        """
        links = [self._link(r) for r in rids]
        if capacities is not None:
            for r, c in zip(rids, capacities):
                if c is not None:
                    self.observe_capacity(c, rid=r)
        caps = np.array([link.capacity_ema for link in links], np.float64)
        ticks = np.array([link.ticks for link in links], np.int64)
        cur = np.array([link.mode for link in links], np.int64)
        budgets = np.array([self._req(r).latency_budget_s for r in rids])
        min_accs = np.array([self._req(r).min_acc for r in rids])

        # rank modes by relevance (shared EMA loss, ascending) once per tick
        ranked = sorted(self.profiles, key=lambda p: self.loss_ema[p.mode])
        pay_r = np.array([p.payload_bytes for p in ranked], np.float64)
        acc_r = np.array([p.expected_acc for p in ranked])
        mode_r = np.array([p.mode for p in ranked], np.int64)

        # feasibility: [N, M] transfer latencies against per-link budgets
        tx = pay_r[None, :] / np.maximum(caps[:, None], 1.0) + RTT_SECONDS
        feasible = tx <= budgets[:, None]
        feasible[ticks == 0, :] = True          # cold start: optimistic
        ok = feasible & ((min_accs[:, None] <= 0.0)
                         | (acc_r[None, :] >= min_accs[:, None]))
        any_ok = ok.any(axis=1)
        chosen = mode_r[np.argmax(ok, axis=1)]  # most relevant feasible
        fallback = min(self.profiles, key=lambda p: p.payload_bytes).mode
        chosen = np.where(any_ok, chosen, fallback)

        # hysteresis: an upgrade (larger payload than current) must stay
        # feasible at capacity * hysteresis, else keep the current mode
        pos = {p.mode: i for i, p in enumerate(self.profiles)}
        pay_m = np.array([p.payload_bytes for p in self.profiles], np.float64)
        pay_cho = pay_m[[pos[int(m)] for m in chosen]]
        pay_cur = pay_m[[pos[int(m)] for m in cur]]
        upgrade = (ticks > 0) & (chosen != cur) & (pay_cho > pay_cur)
        tx_h = pay_cho / np.maximum(caps * self.hysteresis, 1.0) + RTT_SECONDS
        chosen = np.where(upgrade & (tx_h > budgets), cur, chosen)

        if hold is not None:
            chosen = np.where(np.asarray(hold, bool), cur, chosen)
        if commit:
            for link, m in zip(links, chosen):
                if int(m) != link.mode:
                    link.switches += 1
                    link.mode = int(m)
        return chosen.astype(np.int32)

    def force_mode(self, rid: Optional[Hashable], mode: int) -> int:
        """Set a link's mode directly (the controller's commit point after
        an uncommitted ``choose_modes`` pass, including deadline
        escalations). Counts a switch when it changes."""
        s = self._link(rid)
        if mode != s.mode:
            s.switches += 1
            s.mode = mode
        return s.mode

    def requirement_for(self, rid: Optional[Hashable] = None) -> AppRequirement:
        """The effective ``AppRequirement`` for a link: the one registered
        for ``rid``, else the orchestrator-wide default."""
        return self._req(rid)
