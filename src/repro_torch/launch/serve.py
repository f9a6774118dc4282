"""Serving launcher of the port: requests through the continuous-batching
split engine, with the orchestrator picking each slot's transmit mode from
simulated mmWave channels (mirrors ``repro.launch.serve --engine
continuous``).

    # on the card, full width, random weights from --seed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --engine continuous --requests 8 --prompt-len 16 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --engine continuous --cache-len 2048
    # the plain PyTorch path on the CPU, reduced shapes
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduced --engine continuous --device cpu

qwen2.5-3b serves from the paged pool, recurrentgemma-2b (RG-LRU and
local-attention blocks) from the dense slot pool, whose rolling caches
hold ``min(--cache-len, local_window)`` rows.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises rather than falling back to the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import bottleneck
from repro_torch.core import split as SP
from repro_torch.core.channel import ChannelConfig, channel_fleet
from repro_torch.core.orchestrator import (AppRequirement, ModeProfile,
                                           Orchestrator)
from repro_torch.data.tokens import MarkovTokenSource
from repro_torch.serving import (ContinuousBatchingEngine, ControllerConfig,
                                 ModeController, Request)


def build_orchestrator(cfg, batch: int, latency_budget_s: float,
                       *, hysteresis: float = 0.85):
    """Mode profiles from the analytic payload model (calibration stands in
    for the cascade validation losses on untrained weights)."""
    profiles = []
    for m in range(cfg.split.n_modes):
        pb = bottleneck.mode_payload_bytes(cfg, batch, 1, m)
        profiles.append(ModeProfile(mode=m, payload_bytes=pb,
                                    expected_loss=float(m)))  # DPI ordering
    return Orchestrator(profiles,
                        AppRequirement(latency_budget_s=latency_budget_s),
                        hysteresis=hysteresis)


def resolve_device(name: str) -> torch.device:
    """The device the caller asked for; CUDA without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "the plain PyTorch path on the CPU")
    return dev


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_summary(prof, seconds: float, top: int = 12) -> dict:
    """Device busy time of a ``torch.profiler`` run: the sum of its CUDA
    kernels' durations (one stream, so they do not overlap), the idle
    share of the wall time, and the kernels that took the most time."""
    by_name = {}
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": seconds, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / max(seconds, 1e-9),
            "kernel_launches": sum(n for _, n in by_name.values()),
            "top_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                            for k, (us, n) in rows]}


def run_continuous(args, cfg, params):
    dev = params["embed"]["table"].device
    orch = build_orchestrator(cfg, 1, args.latency_budget_ms / 1e3,
                              hysteresis=1.0)
    chans = channel_fleet(
        args.requests,
        ChannelConfig(mean_mbps=args.mean_mbps, std_mbps=args.mean_mbps / 2,
                      blockage_prob=0.06, recovery_prob=0.2,
                      seed=args.channel_seed),
        seed=args.channel_seed, mean_spread=0.9)
    src = MarkovTokenSource(cfg, seed=7)
    batch = src.batch(args.requests, args.prompt_len)["tokens"]
    reqs = [Request(rid=i, prompt=np.asarray(batch[i]),
                    max_new_tokens=args.gen, channel=chans[i],
                    arrival_tick=i * args.arrival_every)
            for i in range(args.requests)]
    kw = {}
    if args.mode_policy == "adaptive":
        kw["controller"] = ModeController(
            orch, ControllerConfig(dwell_ticks=args.dwell_ticks))
    else:
        kw["orchestrator"] = orch
        kw["freeze_modes"] = args.mode_policy == "frozen"
    eng = ContinuousBatchingEngine(params, cfg, n_slots=args.n_slots,
                                   cache_len=args.cache_len, **kw)
    # run every prefill batch bucket and window length once, so the
    # decode rate measures steady-state serving
    eng.warm(np.asarray(batch[0]))
    prof = None
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    _sync(dev)
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        done = eng.run(reqs)
        _sync(dev)
    seconds = time.perf_counter() - t0
    st = eng.stats()
    extra = {}
    if prof is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
        extra["profile"] = profile_summary(prof, seconds)
    return {
        "engine": "continuous",
        "device": str(dev),
        "n_slots": args.n_slots,
        "seconds": seconds,
        "decode_tok_per_s": st["decode_tokens"] / max(seconds, 1e-9),
        "per_request": [s.result() for s in done[:4]],
        "tokens": {s.request.rid: list(s.tokens) for s in done},
        **extra,
        **st,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="continuous", choices=["continuous"],
                    help="the sync, cluster and fleet engines are not "
                         "ported yet")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128,
                    help="per-slot context (paged: the arena's rows per "
                         "slot; windowed archs cap it at their window)")
    ap.add_argument("--latency-budget-ms", type=float, default=5.0)
    ap.add_argument("--channel-seed", type=int, default=0)
    ap.add_argument("--n-slots", type=int, default=4,
                    help="decode slot pool size")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="ticks between request arrivals")
    ap.add_argument("--mode-policy", default="pertick",
                    choices=["pertick", "adaptive", "frozen"])
    ap.add_argument("--dwell-ticks", type=int, default=2,
                    help="adaptive policy: min ticks between mode switches")
    ap.add_argument("--mean-mbps", type=float, default=40.0,
                    help="fleet mean uplink")
    ap.add_argument("--profile-dir", default=None,
                    help="trace the measured run with torch.profiler: a "
                         "Chrome trace lands here and the device busy "
                         "time in the summary")
    ap.add_argument("--json-out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"== repro_torch.launch.serve {args.arch} "
          f"({'reduced' if args.reduced else 'FULL'}) on {dev} "
          f"requests={args.requests} prompt={args.prompt_len} "
          f"gen={args.gen} ==", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = SP.init_split_params(gen, cfg)
    summary = {"arch": args.arch, **run_continuous(args, cfg, params)}
    printed = {k: v for k, v in summary.items() if k != "tokens"}
    print(json.dumps(printed, indent=1, default=str))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(printed, f, indent=1, default=str)
    return summary


if __name__ == "__main__":
    main()
