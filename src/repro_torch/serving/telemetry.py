"""Serving telemetry: metrics registry + structured trace timeline (a port of
``repro.serving.telemetry``; event names, categories, args and export
formats are the reference's, so traces and Prometheus text carry the same
names).

Two halves, both dependency-free (numpy only):

1. :class:`MetricsRegistry` — named counters, gauges, and log-bucketed
   histograms (geometric bucket edges, ``np.searchsorted`` placement)
   with p50/p90/p99/max summaries, exportable as a JSON snapshot
   (:meth:`MetricsRegistry.snapshot`) or Prometheus text exposition
   (:meth:`MetricsRegistry.prometheus`). The serving engines observe
   TTFT, inter-token latency, window dispatch/materialize wall time,
   wire bytes, queue depth, and pool occupancy into it; the existing
   ``stats()`` dicts are mirrored in via :meth:`MetricsRegistry.ingest`
   so both views always agree.

2. :class:`TraceRecorder` — a bounded ring buffer of structured events
   (admission verdicts, mode switches and escalations, migration
   send/inject, handovers, autoscale decisions, decode-window spans)
   stamped on the shared monotonic clock and exportable as Chrome
   trace-event JSON (:meth:`TraceRecorder.chrome_trace`), loadable in
   Perfetto / ``chrome://tracing``. Lanes (one per cluster replica,
   plus a control-plane lane) render as separate processes.

:class:`Telemetry` bundles one registry + one recorder + a lane id; an
``EdgeCluster`` hands each replica a :meth:`Telemetry.for_lane` view so
every engine writes the same registry and the same merged timeline.

The module also owns the ONE serving wall clock (:func:`now` —
``time.monotonic``; ``Session.t_submit``, engine spans, launcher timing
and the training loop all read it) and the shared bench timing helpers
(:class:`Stopwatch`, :func:`best_of`, :func:`time_us`) that the
benchmarks previously each re-implemented.

The decode window never synchronizes with the host for telemetry: the
per-tick int32 block ``[wire_bytes, live_slots, mode_hist...]`` is a
function of the window's mode matrix and frozen live mask, which the host
already holds, so the engine computes it there (``batcher._tel_block``)
and folds it into the registry one window late, when the window's tokens
are read, exactly like the reference's scan output. ``profile_capture``
wraps ``torch.profiler`` and writes a Chrome trace into its directory.
"""
from __future__ import annotations

import contextlib
import json
import re
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# the one clock
# ---------------------------------------------------------------------------

def now() -> float:
    """THE serving wall clock (monotonic seconds). Every span, TTFT and
    bench wall-time measurement reads this one function, so timestamps
    from different layers are always comparable."""
    return time.monotonic()


class Stopwatch:
    """Wall-time span on the shared clock.

    >>> with Stopwatch() as sw:
    ...     work()
    >>> sw.seconds        # frozen at exit
    ``sw.lap()`` reads the running time while the block is still open.
    """

    def __enter__(self) -> "Stopwatch":
        self.t0 = now()
        self.seconds = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = now() - self.t0

    def lap(self) -> float:
        return now() - self.t0


def best_of(fn, *args, repeats: int = 3):
    """Best-of-``repeats`` wall seconds for ``fn(*args)`` — the bench
    timing idiom (min over repeats rejects scheduler noise). Returns
    ``(best_seconds, last_result)``."""
    best, out = float("inf"), None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best, out


def block(out) -> None:
    """Wait for the device work behind ``out`` (a tensor or a tuple/list of
    them); nothing to wait for on the CPU."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if torch.is_tensor(t) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


def time_us(fn, *args, iters: int = 20) -> float:
    """Best-of-``iters`` microseconds of ``fn(*args)``: one warm-up call,
    then the minimum over ``iters`` timed calls, each ended by a device
    synchronize (host clock; the wall time of a call, launches included)."""
    block(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        block(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class Counter:
    """Monotone event/byte counter."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def reset(self):
        self.value = 0

    def summary(self):
        return self.value


class Gauge:
    """Last-written instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v):
        self.value = float(v)

    def reset(self):
        self.value = 0.0

    def summary(self):
        return self.value


class Histogram:
    """Log-bucketed histogram with percentile summaries.

    ``n_buckets`` geometric upper edges span ``[lo, hi]``; an overflow
    bucket catches values past ``hi``. A quantile estimate is the upper
    edge of the bucket holding the target rank, so it is exact to within
    one bucket ratio (``(hi/lo) ** (1 / (n_buckets - 1))`` — ~1.21x at
    the defaults, 8 decades over 96 buckets). ``observe(v, n)`` records
    ``n`` identical observations in one update (the windowed decode loop
    lands whole windows at once).
    """

    kind = "histogram"

    def __init__(self, name: str, *, lo: float = 1e-6, hi: float = 100.0,
                 n_buckets: int = 96):
        if not (0 < lo < hi) or n_buckets < 2:
            raise ValueError(f"bad histogram range [{lo}, {hi}] "
                             f"x {n_buckets}")
        self.name = name
        self.edges = np.geomspace(lo, hi, n_buckets)
        self.counts = np.zeros(n_buckets + 1, np.int64)   # +1: overflow
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def observe(self, value, n: int = 1):
        v = float(value)
        self.counts[int(np.searchsorted(self.edges, v))] += n
        self.sum += v * n
        self.count += n
        if v > self.max:
            self.max = v

    def reset(self):
        self.counts[:] = 0
        self.sum = 0.0
        self.count = 0
        self.max = 0.0

    def quantile(self, q: float) -> float:
        """Upper bucket edge at rank ``ceil(q * count)`` (0 when empty)."""
        if self.count == 0:
            return 0.0
        target = max(int(np.ceil(q * self.count)), 1)
        idx = int(np.searchsorted(np.cumsum(self.counts), target))
        if idx >= len(self.edges):        # overflow bucket
            return self.max
        return float(self.edges[idx])

    def summary(self) -> dict:
        return {
            "count": int(self.count),
            "sum": float(self.sum),
            "mean": self.sum / self.count if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "max": float(self.max),
        }


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    One registry serves a whole cluster: engines address metrics by name
    (``inc`` / ``set`` / ``observe`` auto-create), exporters walk the
    registry. Hot-path writers hold references to the metric objects
    instead of re-resolving names per tick.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def inc(self, name: str, n=1):
        self.counter(name).inc(n)

    def set(self, name: str, v):
        self.gauge(name).set(v)

    def observe(self, name: str, v, n: int = 1):
        self.histogram(name).observe(v, n)

    def get(self, name: str):
        return self._metrics.get(name)

    def reset(self):
        """Zero every metric in place (bucket layouts and references
        survive) — the engines call this from ``reset_counters`` so a
        warm-up run's compile-time spikes never land in measured
        percentiles."""
        for m in self._metrics.values():
            m.reset()

    def ingest(self, prefix: str, stats: dict):
        """Mirror a ``stats()`` dict into gauges (``prefix.key``), nested
        dicts flattened — the registry view of the legacy totals, so JSON
        snapshot and Prometheus exposition carry them too."""
        for k, v in stats.items():
            name = f"{prefix}.{k}"
            if isinstance(v, dict):
                self.ingest(name, v)
            elif isinstance(v, (bool, int, float, np.integer, np.floating)):
                self.set(name, float(v))

    def snapshot(self) -> dict:
        """JSON-able view: counters/gauges as numbers, histograms as
        count/sum/mean/p50/p90/p99/max summaries."""
        return {name: m.summary()
                for name, m in sorted(self._metrics.items())}

    def prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4): counters and
        gauges as single samples, histograms as the standard cumulative
        ``_bucket{le=...}`` / ``_sum`` / ``_count`` series."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} {m.kind}")
            if m.kind == "histogram":
                cum = 0
                for edge, c in zip(m.edges, m.counts):
                    cum += int(c)
                    lines.append(f'{pn}_bucket{{le="{edge:.9g}"}} {cum}')
                lines.append(f'{pn}_bucket{{le="+Inf"}} {int(m.count)}')
                lines.append(f"{pn}_sum {m.sum:.9g}")
                lines.append(f"{pn}_count {int(m.count)}")
            else:
                lines.append(f"{pn} {m.summary():.9g}"
                             if isinstance(m.summary(), float)
                             else f"{pn} {m.summary()}")
        return "\n".join(lines) + "\n"

    def latency_summary(self, *names: str) -> dict:
        """Millisecond p50/p90/p99/max for the named second-valued
        histograms — the bench artifact's percentile section."""
        out = {}
        for name in names:
            h = self._metrics.get(name)
            if isinstance(h, Histogram) and h.count:
                s = h.summary()
                out[name] = {k: round(s[k] * 1e3, 3)
                             for k in ("p50", "p90", "p99", "max")}
                out[name]["count"] = s["count"]
        return out


# ---------------------------------------------------------------------------
# trace timeline
# ---------------------------------------------------------------------------

class TraceRecorder:
    """Bounded ring buffer of Chrome trace events.

    Events are plain dicts in the Chrome trace-event JSON schema
    (``ph="i"`` instants, ``ph="X"`` complete spans; timestamps in
    microseconds since the recorder's epoch on the shared monotonic
    clock). ``pid`` carries the lane (cluster replica); Perfetto renders
    each lane as its own process track, named via ``M`` metadata events
    emitted at export. The deque drops the OLDEST events under pressure
    (``dropped`` counts them) — a trace is a window onto the recent
    past, never a memory leak.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._emitted = 0
        self.t0 = now()
        self._lanes: Dict[int, str] = {}

    @property
    def dropped(self) -> int:
        return self._emitted - len(self._events)

    def set_lane(self, lane: int, name: str):
        self._lanes[int(lane)] = str(name)

    def _us(self, t: float) -> float:
        return (t - self.t0) * 1e6

    def _emit(self, ev: dict):
        self._events.append(ev)
        self._emitted += 1

    def instant(self, name: str, *, lane: int = 0, cat: str = "serving",
                t: Optional[float] = None, **args):
        """A point event (``ph="i"``, process-scoped)."""
        self._emit({"name": name, "ph": "i", "s": "p", "cat": cat,
                    "ts": self._us(now() if t is None else t),
                    "pid": int(lane), "tid": 0, "args": args})

    def complete(self, name: str, t_start: float, dur_s: float, *,
                 lane: int = 0, cat: str = "serving", **args):
        """A closed span (``ph="X"`` with an explicit duration)."""
        self._emit({"name": name, "ph": "X", "cat": cat,
                    "ts": self._us(t_start), "dur": dur_s * 1e6,
                    "pid": int(lane), "tid": 0, "args": args})

    @contextlib.contextmanager
    def span(self, name: str, *, lane: int = 0, cat: str = "serving",
             **args):
        t0 = now()
        try:
            yield
        finally:
            self.complete(name, t0, now() - t0, lane=lane, cat=cat, **args)

    def events(self) -> list:
        return list(self._events)

    def chrome_trace(self) -> dict:
        """The exportable ``{"traceEvents": [...]}`` document: lane-name
        ``M`` metadata first, then the buffered events."""
        meta = [{"name": "process_name", "ph": "M", "pid": lane, "tid": 0,
                 "args": {"name": name}}
                for lane, name in sorted(self._lanes.items())]
        return {"traceEvents": meta + list(self._events),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


# ---------------------------------------------------------------------------
# the facade engines carry
# ---------------------------------------------------------------------------

class Telemetry:
    """One registry + one trace timeline + this writer's lane.

    ``for_lane(i, name)`` returns a view sharing both halves but
    stamping events into lane ``i`` — the ``EdgeCluster`` keeps lane 0
    for control-plane events (admission, autoscale, routing) and hands
    replica ``r`` lane ``r + 1``, so one exported trace shows every
    replica's decode windows against the cluster's decisions.
    """

    def __init__(self, *, trace_capacity: int = 65536, lane: int = 0,
                 lane_name: str = "serving"):
        self.registry = MetricsRegistry()
        self.trace = TraceRecorder(capacity=trace_capacity)
        self.lane = int(lane)
        self.trace.set_lane(self.lane, lane_name)

    def for_lane(self, lane: int, name: Optional[str] = None) -> "Telemetry":
        view = Telemetry.__new__(Telemetry)
        view.registry = self.registry
        view.trace = self.trace
        view.lane = int(lane)
        if name is not None:
            self.trace.set_lane(lane, name)
        return view

    # thin lane-stamped pass-throughs
    def instant(self, name: str, **args):
        self.trace.instant(name, lane=self.lane, **args)

    def span(self, name: str, **args):
        return self.trace.span(name, lane=self.lane, **args)

    def complete(self, name: str, t_start: float, dur_s: float, **args):
        self.trace.complete(name, t_start, dur_s, lane=self.lane, **args)

    def inc(self, name: str, n=1):
        self.registry.inc(name, n)

    def set(self, name: str, v):
        self.registry.set(name, v)

    def observe(self, name: str, v, n: int = 1):
        self.registry.observe(name, v, n)


# ---------------------------------------------------------------------------
# optional torch.profiler capture
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def profile_capture(profile_dir: Optional[str]):
    """Wrap a region in a ``torch.profiler`` trace when ``profile_dir`` is
    set (host ops, and the card's kernels when CUDA is available), written
    as ``trace.json`` (Chrome trace) into that directory; a no-op
    otherwise. Yields the profiler (or None)."""
    if not profile_dir:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
