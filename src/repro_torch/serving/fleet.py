"""Fleet-scale load generation and SLO-driven admission control (a copy
of ``repro.serving.fleet``).

Two pieces the city-scale bench and the elastic ``EdgeCluster`` share:

* :func:`fleet_requests` — a deterministic load generator: Poisson or
  heavy-tail (Pareto) arrival processes over thousands of UEs, each UE
  riding its own lane of one vectorized
  :class:`~repro_torch.core.channel.FleetChannel` (no per-UE Python channel
  objects anywhere), each request carrying a session-level
  ``slo_ticks`` deadline.
* :class:`SLOAdmission` — the admission gate: decisions come from
  *predicted deadline-miss*, not just slot pressure. A request is
  rejected outright when its link is hopeless (even the cheapest
  calibrated payload cannot meet the per-token budget at the UE's
  observed capacity) or when the predicted queue wait plus service time
  already exceeds its session SLO; it is *parked* (deferred, retried
  each cluster step, aged out to a rejection) under transient backlog
  pressure the autoscaler may yet relieve.

The gate is a pure decision function of scalars — no cluster reference —
so it unit-tests without any engine and the cluster stays the single
place that derives the signals.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional

import numpy as np

from repro_torch.core.channel import FleetChannel, tx_seconds
from repro_torch.serving.session import Request

ARRIVALS = ("poisson", "heavy-tail", "burst")


# ---------------------------------------------------------------------------
# SLO-driven admission
# ---------------------------------------------------------------------------

@dataclass
class SLOAdmissionConfig:
    #: per-token transfer budget the link-hopeless test measures against
    latency_budget_s: float = 0.006
    #: reject when the cheapest payload's transfer time exceeds
    #: ``hopeless_factor * latency_budget_s`` at the observed capacity
    hopeless_factor: float = 2.0
    #: park (defer) when cluster backlog exceeds this many waiting
    #: requests per aggregate live slot
    park_queue_per_slot: float = 1.0
    #: parked longer than this many cluster steps -> terminal rejection
    park_max_ticks: int = 64


class SLOAdmission:
    """Predictive admission gate. ``decide`` returns ``"admit"``,
    ``"park"``, or ``"reject"``, tallies per-reason counters, and appends
    one structured record per decision to the bounded ``events`` deque
    (verdict, reason, predicted deadline margin, queue-per-slot at
    decision time) — fleet-bench rejections stay auditable post-hoc.
    Attaching a :class:`~repro_torch.serving.telemetry.Telemetry` (the cluster
    does this on its control-plane lane) additionally stamps every
    decision onto the trace timeline."""

    def __init__(self, min_payload_bytes: Optional[int] = None,
                 cfg: Optional[SLOAdmissionConfig] = None, *,
                 events_capacity: int = 4096):
        self.min_payload_bytes = min_payload_bytes
        self.cfg = cfg if cfg is not None else SLOAdmissionConfig()
        self.admitted = 0
        self.rejected_link = 0       # link-hopeless rejections
        self.rejected_deadline = 0   # predicted session-SLO miss
        self.parked = 0
        #: last ``events_capacity`` decision records (oldest dropped)
        self.events: Deque[dict] = deque(maxlen=int(events_capacity))
        #: optional :class:`~repro_torch.serving.telemetry.Telemetry`; when set,
        #: every decision also lands on the trace timeline as an instant
        self.telemetry = None

    def decide(self, *, slo_ticks: Optional[int],
               predicted_wait_ticks: int, service_ticks: int,
               capacity_bps: Optional[float] = None,
               queue_per_slot: float = 0.0, rid=None) -> str:
        verdict, reason = "admit", "ok"
        if capacity_bps is not None and self.min_payload_bytes:
            tx = tx_seconds(self.min_payload_bytes,
                            max(float(capacity_bps), 1.0))
            if tx > self.cfg.hopeless_factor * self.cfg.latency_budget_s:
                verdict, reason = "reject", "link_hopeless"
        # predicted margin: SLO ticks left after queue wait + service time
        # (negative = predicted miss); None when the request carries no SLO
        margin = (slo_ticks - (predicted_wait_ticks + service_ticks)
                  if slo_ticks is not None else None)
        if verdict == "admit":
            if margin is not None and margin < 0:
                verdict, reason = "reject", "deadline"
            elif queue_per_slot > self.cfg.park_queue_per_slot:
                verdict, reason = "park", "backlog"
        if reason == "link_hopeless":
            self.rejected_link += 1
        elif reason == "deadline":
            self.rejected_deadline += 1
        elif verdict == "park":
            self.parked += 1
        else:
            self.admitted += 1
        record = {"rid": rid, "verdict": verdict, "reason": reason,
                  "margin_ticks": margin,
                  "predicted_wait_ticks": int(predicted_wait_ticks),
                  "service_ticks": int(service_ticks),
                  "queue_per_slot": round(float(queue_per_slot), 4)}
        self.events.append(record)
        if self.telemetry is not None:
            self.telemetry.instant("slo_admission", cat="admission",
                                   **record)
        return verdict

    def stats(self) -> dict:
        return {
            "admitted": self.admitted,
            "rejected_link": self.rejected_link,
            "rejected_deadline": self.rejected_deadline,
            "parked": self.parked,
        }


# ---------------------------------------------------------------------------
# load generation
# ---------------------------------------------------------------------------

@dataclass
class FleetLoadConfig:
    """One request per UE, arrival times drawn from a renewal process.

    ``poisson`` draws exponential interarrivals (memoryless, smooth
    offered load); ``heavy-tail`` draws mean-matched Pareto interarrivals
    (``pareto_alpha``), giving the bursty flash-crowd arrivals real
    mobile traffic shows; ``burst`` packs all arrivals into the first
    ``burst_ticks`` ticks uniformly (worst-case stampede).
    """
    arrival: str = "poisson"
    mean_interarrival_ticks: float = 2.0
    pareto_alpha: float = 1.5           # heavy-tail shape (alpha > 1)
    burst_ticks: int = 8
    prompt_len: int = 8
    prompt_len_jitter: int = 0          # +/- uniform jitter on prompt_len
    max_new_tokens: int = 8
    vocab: int = 256
    slo_ticks: Optional[int] = 96       # session deadline; None: no SLO
    seed: int = 0


def arrival_ticks(n: int, cfg: FleetLoadConfig) -> np.ndarray:
    """Deterministic arrival tick per request ``[n] int64`` (sorted)."""
    if cfg.arrival not in ARRIVALS:
        raise ValueError(f"arrival must be one of {ARRIVALS}")
    if n < 1:
        raise ValueError("need at least one request")
    rng = np.random.default_rng(cfg.seed)
    mean = float(cfg.mean_interarrival_ticks)
    if cfg.arrival == "poisson":
        gaps = rng.exponential(mean, size=n)
    elif cfg.arrival == "heavy-tail":
        a = float(cfg.pareto_alpha)
        if a <= 1.0:
            raise ValueError("pareto_alpha must be > 1 (finite mean)")
        # standard Pareto (x_m = 1) has mean a/(a-1); rescale to `mean`
        gaps = (rng.pareto(a, size=n) + 1.0) * mean * (a - 1.0) / a
    else:                               # burst
        return np.sort(rng.integers(0, max(cfg.burst_ticks, 1),
                                    size=n)).astype(np.int64)
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def fleet_requests(fleet: FleetChannel,
                   cfg: Optional[FleetLoadConfig] = None, *,
                   requirement=None) -> List[Request]:
    """One :class:`Request` per fleet lane, arrival-ordered.

    Request ``i`` rides ``fleet.lane(i)`` — a stateless view into the
    vectorized fleet, so the serving hot path never touches a per-UE
    Python channel object. Prompts are seeded token arrays; every
    request carries ``cfg.slo_ticks`` for the admission gate and the
    cluster's session-SLO accounting.
    """
    cfg = cfg if cfg is not None else FleetLoadConfig()
    n = fleet.n
    ticks = arrival_ticks(n, cfg)
    rng = np.random.default_rng(cfg.seed + 1)
    jit = int(cfg.prompt_len_jitter)
    lens = (rng.integers(-jit, jit + 1, size=n) + cfg.prompt_len
            if jit else np.full(n, cfg.prompt_len))
    lens = np.maximum(lens, 1)
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab, size=int(lens[i]),
                                        dtype=np.int32),
                    max_new_tokens=cfg.max_new_tokens,
                    channel=fleet.lane(i),
                    requirement=requirement,
                    arrival_tick=int(ticks[i]),
                    slo_ticks=cfg.slo_ticks)
            for i in range(n)]
