"""Serving launcher of the port: requests through the split engine, with
the orchestrator picking the transmit mode from simulated mmWave channels
(mirrors ``repro.launch.serve --engine sync|continuous``).

    # synchronous static batch (the default engine), on the card at full
    # width, random weights from --seed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --requests 8 --prompt-len 16 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --cache-len 2048 --policy static1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-20b
    # continuous batching: per-request channels, per-slot bottleneck modes
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --engine continuous --requests 8 --prompt-len 16 --gen 16
    # the plain PyTorch path on the CPU, reduced shapes
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduced --device cpu [--engine continuous]
    # trained weights (repro_torch.launch.train's checkpoint)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --ckpt results/ckpt/qwen2_5-3b.npz

Policies (sync engine):
  orchestrator  the paper's dynamic policy (channel feedback, hysteresis)
  static0       always mode 0 (raw boundary, most informative)
  static1       always mode 1 (bottleneck z', cheapest)

``--arch`` takes the archs of the port's registry. The continuous engine
serves the dense archs (qwen2.5-3b, stablelm-3b, granite-8b,
internlm2-20b) from the paged pool, and recurrentgemma-2b (RG-LRU and
local-attention blocks) and xlstm-125m (mLSTM and sLSTM blocks) from the
dense slot pool, whose rolling caches hold ``min(--cache-len,
local_window)`` rows (the recurrent carries do not depend on it); the
sync engine keeps one dense state of ``--requests`` rows.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises rather than falling back to the CPU.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import bottleneck
from repro_torch.core import split as SP
from repro_torch.core.channel import Channel, ChannelConfig, channel_fleet
from repro_torch.core.orchestrator import (AppRequirement, ModeProfile,
                                           Orchestrator)
from repro_torch.data.tokens import MarkovTokenSource
from repro_torch.models import transformer as T
from repro_torch.serving import (ContinuousBatchingEngine, ControllerConfig,
                                 ModeController, Request, ServingEngine)
from repro_torch.training import checkpoint


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
    share of the wall time, the kernels that took the most time, and the
    calls and device time of ``aten::_to_copy`` (dtype casts, and the few
    host-to-device uploads of tokens and positions; its device time is
    that of the kernels launched by a cast or by an op nested in one, as
    ``key_averages`` counts it). Read from the profiler's raw events: the
    ``FunctionEvent`` tree of ``prof.events()`` costs far more host time
    than the run it describes at full width."""
    from torch.autograd import DeviceType
    by_name, kernels, ops, casts = {}, [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
            kernels.append((e.linked_correlation_id(), e.duration_ns()))
        elif e.linked_correlation_id() == 0:     # an op called on the host
            t, start = e.start_thread_id(), e.start_ns()
            ops[e.correlation_id()] = (t, start)
            if e.name() == "aten::_to_copy":
                casts.setdefault(t, []).append((start, e.end_ns()))
    for spans in casts.values():
        spans.sort()
    starts = {t: [a for a, _ in spans] for t, spans in casts.items()}

    def in_cast(op) -> bool:
        t, start = op
        i = bisect.bisect_right(starts.get(t, ()), start) - 1
        return i >= 0 and start <= casts[t][i][1]

    cast_ns = sum(ns for corr, ns in kernels
                  if corr in ops and in_cast(ops[corr]))
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": seconds, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / max(seconds, 1e-9),
            "kernel_launches": sum(n for _, n in by_name.values()),
            "to_copy": {"calls": sum(len(v) for v in casts.values()),
                        "device_ms": cast_ns / 1e6},
            "top_kernels": [{"name": k[:80], "ms": us / 1e3, "calls": n}
                            for k, (us, n) in rows]}


def make_profiler(args, dev):
    """A ``torch.profiler`` for the measured run when ``--profile-dir`` is
    given (tracing the card's kernels on CUDA), else None."""
    if not args.profile_dir:
        return None
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def profile_extra(args, prof, seconds: float) -> dict:
    """Export the profiled run's Chrome trace to ``--profile-dir`` and
    summarize it; nothing without a profiler."""
    if prof is None:
        return {}
    os.makedirs(args.profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    return {"profile": profile_summary(prof, seconds)}


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
    prof = make_profiler(args, dev)
    _sync(dev)
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        done = eng.run(reqs)
        _sync(dev)
    seconds = time.perf_counter() - t0
    st = eng.stats()
    return {
        "engine": "continuous",
        "device": str(dev),
        "n_slots": args.n_slots,
        "seconds": seconds,
        "decode_tok_per_s": st["decode_tokens"] / max(seconds, 1e-9),
        "per_request": [s.result() for s in done[:4]],
        "tokens": {s.request.rid: list(s.tokens) for s in done},
        **profile_extra(args, prof, seconds),
        **st,
    }


def run_sync(args, cfg, params):
    """One static batch of ``--requests`` Markov prompts: a batched prefill,
    the first token from its logits, then ``--gen`` decode steps, each on
    the policy's mode (the orchestrator's from one shared channel, or a
    fixed one). Wall times end in a device synchronize."""
    dev = params["embed"]["table"].device
    orch = None
    if args.policy == "orchestrator":
        orch = build_orchestrator(cfg, args.requests,
                                  args.latency_budget_ms / 1e3)
    eng = ServingEngine(params, cfg, cache_len=args.cache_len,
                        batch=args.requests, orchestrator=orch)
    src = MarkovTokenSource(cfg, seed=7)
    prompt = torch.from_numpy(
        src.batch(args.requests, args.prompt_len)["tokens"]).to(dev)
    chan = Channel(ChannelConfig(seed=args.channel_seed))
    prof = make_profiler(args, dev)
    _sync(dev)
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        logits = eng.prefill(prompt)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        if args.policy.startswith("static"):
            # the cache-wraparound guard decode_tokens applies
            T.check_cache_capacity(cfg, eng.pos, args.gen, args.cache_len,
                                   what="--gen")
            mode = int(args.policy[-1])
            out, wire = [], 0
            tok = first
            for _ in range(args.gen):
                logits, eng.states, pb = SP.split_decode_step(
                    eng.params, tok, eng.states, eng.pos, cfg, mode=mode)
                eng.pos += 1
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                out.append(tok)
                wire += int(pb)
            gen = torch.cat(out, dim=-1).cpu().numpy()
            stats = {"tokens": int(gen.size), "wire_bytes": wire,
                     "mode_counts": {mode: args.gen}}
        else:
            gen = eng.decode_tokens(first, args.gen,
                                    capacity_bps_fn=chan.step)
            stats = {"tokens": eng.stats.tokens,
                     "wire_bytes": eng.stats.wire_bytes,
                     "mode_counts": eng.stats.mode_counts,
                     "mode_switches": orch.state.switches}
        _sync(dev)
    t_total = time.perf_counter() - t0
    toks = args.requests * args.gen
    return {
        "engine": "sync", "policy": args.policy, "device": str(dev),
        "prefill_s": t_prefill,
        "decode_tok_per_s": toks / max(t_total - t_prefill, 1e-9),
        "wire_bytes_per_token": stats["wire_bytes"] / max(toks, 1),
        "generated": gen.tolist(),
        **profile_extra(args, prof, t_total),
        **stats,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS,
                    help="an arch of the port's registry: dense "
                         "(qwen2.5-3b, stablelm-3b, granite-8b, "
                         "internlm2-20b) or recurrent (recurrentgemma-2b, "
                         "xlstm-125m)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="sync",
                    choices=["sync", "continuous"],
                    help="sync: one static batch (the default); continuous: "
                         "continuous batching with per-slot modes (the "
                         "cluster and fleet engines are not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--requests", type=int, default=4,
                    help="number of requests (sync: the batch size)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128,
                    help="per-sequence context (paged: the arena's rows per "
                         "slot; windowed archs cap it at their window)")
    ap.add_argument("--policy", default="orchestrator",
                    choices=["orchestrator", "static0", "static1"],
                    help="sync engine: the mode policy (see above)")
    ap.add_argument("--latency-budget-ms", type=float, default=5.0)
    ap.add_argument("--channel-seed", type=int, default=0,
                    help="seed of the simulated channels")
    ap.add_argument("--n-slots", type=int, default=4,
                    help="continuous engine: decode slot pool size")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="continuous engine: ticks between request "
                         "arrivals")
    ap.add_argument("--mode-policy", default="pertick",
                    choices=["pertick", "adaptive", "frozen"],
                    help="continuous engine: the mode policy")
    ap.add_argument("--dwell-ticks", type=int, default=2,
                    help="adaptive policy: min ticks between mode switches")
    ap.add_argument("--mean-mbps", type=float, default=40.0,
                    help="continuous engine: fleet mean uplink")
    ap.add_argument("--profile-dir", default=None,
                    help="trace the measured run with torch.profiler: a "
                         "Chrome trace lands here and the device busy "
                         "time in the summary")
    ap.add_argument("--ckpt", default=None,
                    help="serve the weights of this checkpoint (the "
                         "reference's .npz layout, written by either "
                         "package's launch.train) instead of random ones")
    ap.add_argument("--json-out", default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"== repro_torch.launch.serve {args.arch} "
          f"({'reduced' if args.reduced else 'FULL'}) on {dev} "
          f"engine={args.engine} "
          f"requests={args.requests} prompt={args.prompt_len} "
          f"gen={args.gen} ==", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = SP.init_split_params(gen, cfg)
    if args.ckpt:
        params = checkpoint.restore(args.ckpt, params)
        print(f"loaded weights from {args.ckpt}", flush=True)
    runner = {"sync": run_sync, "continuous": run_continuous}[args.engine]
    summary = {"arch": args.arch, **runner(args, cfg, params)}
    # the generated tokens are returned, not printed
    printed = {k: v for k, v in summary.items() if k != "generated"
               and not (k == "tokens" and isinstance(v, dict))}
    print(json.dumps(printed, indent=1, default=str))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(printed, f, indent=1, default=str)
    return summary


if __name__ == "__main__":
    main()
