"""CUDA graphs of the serving engines' decode steps: the port's counterpart
of ``jax.jit`` / ``lax.scan`` in ``repro/serving/batcher.py`` (the
continuous engine's decode window, one compiled, donated scan of K ticks:
``_window_scan_body`` built by ``_paged_steps`` / ``_compiled_steps``) and
in ``repro/serving/engine.py`` (the sync engine's jitted ``_tok_step``).

A :class:`StepGraphs` holds one graph per key. Its bodies read only static
inputs (tensors allocated outside any capture and written in place before
a run), update their state in place and write every output a caller reads
into a static buffer. On a CUDA device the first use of a key runs the
body once eagerly on a side stream (the warm-up: the call's own work,
which also builds every lazily made tensor outside the capture), then
captures it; every later use of the key replays the graph on the current
stream. A capture or replay error raises: nothing falls back to eager
steps. On the CPU the body runs eagerly at every use, over the same static
buffers.

Every holder's graphs on a device share one memory pool. That is safe
because no tensor allocated inside a capture outlives its replay: the
graphs replay one at a time on one stream and every output a caller reads
lies in a static buffer.

Launch accounting: a kernel wrapper's ``launches`` counter moves when its
Python code runs, which a replay does not do. A capture records each
counter's rise and takes it back (the capture launched nothing), and each
replay adds the recorded rise, so the counters count the kernels the
device ran, as on the eager path.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Hashable, Tuple

import torch

from repro_torch.kernels import ops

#: per device: the graphs' shared memory pool and the side stream of every
#: warm-up and capture (a pool shared between captures wants one stream)
_POOLS: Dict[torch.device, object] = {}
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _on(device: torch.device):
    """The device's context on the card (a graph replays on the current
    device's current stream)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _side(device: torch.device):
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return _STREAMS[device], _POOLS[device]


class StepGraphs:
    """One captured graph per key of a step body (see the module
    docstring). ``run(key, body, steps)`` runs the body's work once: a
    replay of the key's graph, or on its first use (every use on the CPU)
    the body itself. ``steps`` is the decode steps one run holds (a
    window's K ticks, one sync token step), tallied in ``totals``."""

    #: tallies over every holder of the process, read and zeroed by callers
    #: as the kernels' ``launches`` counters are: graphs captured and
    #: replayed, and the steps run eagerly (a first use), captured and
    #: replayed
    totals = {"captures": 0, "replays": 0, "eager_steps": 0,
              "captured_steps": 0, "replayed_steps": 0}

    def __init__(self, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        #: whether a key's graph is captured (a CUDA device)
        self.capturing = self.device.type == "cuda"
        self._graphs: Dict[Hashable, Tuple[object, Dict[Callable, int]]] = {}
        self.replays = 0

    @property
    def keys(self) -> list:
        """The keys captured so far, in capture order."""
        return list(self._graphs)

    @classmethod
    def reset_totals(cls) -> dict:
        """Zero the process's tallies; returns the dict."""
        for k in cls.totals:
            cls.totals[k] = 0
        return cls.totals

    def run(self, key: Hashable, body: Callable[[], None],
            steps: int = 1) -> None:
        entry = self._graphs.get(key)
        if entry is not None:
            graph, launched = entry
            self._replay(graph)
            for fn, n in launched.items():
                fn.launches += n
            self.replays += 1
            self._tally(replays=1, replayed_steps=steps)
            return
        self._warm(body)
        self._tally(eager_steps=steps)
        if self.capturing:
            before = {fn: fn.launches for fn in ops.KERNELS}
            try:
                graph = self._record(body)
            finally:
                launched = {fn: fn.launches - n for fn, n in before.items()
                            if fn.launches != n}
                for fn, n in before.items():
                    fn.launches = n
            self._graphs[key] = (graph, launched)
            self._tally(captures=1, captured_steps=steps)

    def _tally(self, **counts) -> None:
        for k, n in counts.items():
            StepGraphs.totals[k] += n

    def _warm(self, body: Callable[[], None]) -> None:
        """The body once, eagerly: on a side stream on the card (ordered
        after the current stream's work and before its next)."""
        if self.device.type != "cuda":
            body()
            return
        stream, _ = _side(self.device)
        with _on(self.device):
            cur = torch.cuda.current_stream()
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                body()
            cur.wait_stream(stream)

    def _record(self, body: Callable[[], None]):
        """The body captured into a CUDA graph (nothing runs)."""
        stream, pool = _side(self.device)
        graph = torch.cuda.CUDAGraph()
        with _on(self.device), torch.cuda.graph(graph, pool=pool,
                                                stream=stream):
            body()
        return graph

    def _replay(self, graph) -> None:
        with _on(self.device):
            graph.replay()
