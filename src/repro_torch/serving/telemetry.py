"""The serving clock and the best-of timer (mirrors ``now`` and
``time_us`` of ``repro.serving.telemetry``; the metrics registry, traces
and spans are not ported yet)."""
from __future__ import annotations

import time

import torch


def now() -> float:
    """The serving wall clock (monotonic seconds)."""
    return time.monotonic()


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
