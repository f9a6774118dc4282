"""Request lifecycle for the continuous-batching split-serving engine (a
copy of ``repro.serving.session``).

A ``Request`` is what the UE submits: a prompt, a generation budget, and —
because this is *split* serving — the user's own simulated mmWave link and
(optionally) their application's latency/accuracy requirement. The engine
admits requests from a bounded ``RequestQueue`` into decode slots; each
admitted request becomes a ``Session`` that records, per generated token,
which bottleneck mode the orchestrator chose for *this* user's channel and
what it cost on the wire.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.channel import Channel
from repro_torch.core.orchestrator import AppRequirement


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] tokens (or [K, S] for audio)
    max_new_tokens: int = 32
    channel: Optional[Channel] = None  # this user's uplink (None: engine default)
    requirement: Optional[AppRequirement] = None
    arrival_tick: int = 0              # engine tick at which the UE submits
    #: wall-clock stamps on the shared telemetry clock
    #: (``serving.telemetry.now``), set by the engine: queue entry and
    #: admission pop — TTFT measures from t_submit, the
    #: admission-to-first-token histogram from t_admit
    t_submit: float = 0.0
    t_admit: float = 0.0
    #: session-level SLO in engine ticks: the request should FINISH within
    #: this many ticks of its arrival (queue wait included). ``None`` means
    #: no session SLO — only the per-token latency budget applies. The
    #: fleet admission gate predicts against it and the cluster counts a
    #: session-SLO miss when finished_tick - arrival_tick exceeds it.
    slo_ticks: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[-1])


@dataclass
class Session:
    """One admitted request bound to a decode slot."""
    request: Request
    slot: int
    admitted_tick: int = 0
    gen_budget: int = 0                # effective max_new_tokens (0: the
                                       # request's own; engines may clip it
                                       # to cache capacity at admission)
    pos: int = 0                       # absolute position of the next token
    tokens: List[int] = field(default_factory=list)
    wire_bytes: int = 0                # uplink boundary bytes, this request
    prefill_wire_bytes: int = 0
    transfer_s: float = 0.0            # accumulated simulated link latency
    ttft_s: float = 0.0                # wall clock submit -> first token
    mode_counts: Dict[int, int] = field(default_factory=dict)
    admission_mode: int = 0            # mode chosen when the prompt crossed
    #: (engine_tick, mode) whenever this session's transmit mode changed;
    #: the admission entry is always present, so a session that never
    #: switched has exactly one entry
    mode_trace: List[Tuple[int, int]] = field(default_factory=list)
    deadline_misses: int = 0           # decode tokens whose simulated
    #                                    transfer blew the latency budget
    escalations: int = 0               # controller deadline escalations
    #: one record per live migration this session survived:
    #: {tick, from_replica, to_replica, snapshot_bytes, bits, transfer_s}
    #: (empty for single-engine serving — see serving/migration.py)
    migrations: List[dict] = field(default_factory=list)
    #: channel ticks at which this session's UE crossed a cell boundary
    #: (empty when the request's channel has no mobility)
    handover_ticks: List[int] = field(default_factory=list)
    finished_tick: int = -1

    @property
    def done(self) -> bool:
        budget = self.gen_budget or self.request.max_new_tokens
        return len(self.tokens) >= budget

    def account(self, mode: int, payload_bytes: int, tx_s: float):
        self.wire_bytes += payload_bytes
        self.transfer_s += tx_s
        self.mode_counts[mode] = self.mode_counts.get(mode, 0) + 1

    def result(self) -> dict:
        return {
            "rid": self.request.rid,
            "tokens": list(self.tokens),
            "n_tokens": len(self.tokens),
            "wire_bytes": self.wire_bytes,
            "prefill_wire_bytes": self.prefill_wire_bytes,
            "transfer_s": round(self.transfer_s, 6),
            "ttft_s": round(self.ttft_s, 6),
            "mode_counts": dict(self.mode_counts),
            "admission_mode": self.admission_mode,
            "mode_trace": list(self.mode_trace),
            "mode_switches": max(len(self.mode_trace) - 1, 0),
            "deadline_misses": self.deadline_misses,
            "escalations": self.escalations,
            "migrations": list(self.migrations),
            "handover_ticks": list(self.handover_ticks),
            "admitted_tick": self.admitted_tick,
            "finished_tick": self.finished_tick,
        }


class RequestQueue:
    """Bounded FIFO admission queue. ``submit`` rejects (returns False) when
    the queue is full — back-pressure instead of unbounded memory growth
    under heavy offered load. Backed by a ``deque`` so admission pops are
    O(1) (a list's ``pop(0)`` shifts every queued request per admission —
    O(n) per pop, quadratic over a busy tick's drain)."""

    def __init__(self, max_pending: int = 64):
        self.max_pending = max_pending
        self._q: Deque[Request] = deque()
        self.submitted = 0
        self.rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    def submit(self, req: Request) -> bool:
        if len(self._q) >= self.max_pending:
            self.rejected += 1
            return False
        self._q.append(req)
        self.submitted += 1
        return True

    def pop(self) -> Optional[Request]:
        return self._q.popleft() if self._q else None

    def peek(self) -> Optional[Request]:
        return self._q[0] if self._q else None
