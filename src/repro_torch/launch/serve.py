"""Serving launcher of the port: requests through the split engine, with
the orchestrator picking the transmit mode from simulated mmWave channels
(mirrors ``repro.launch.serve``: engines sync, continuous, cluster and
fleet).

    # synchronous static batch (the default engine), on the card at full
    # width, random weights from --seed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --requests 8 --prompt-len 16 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --cache-len 2048 --policy static1
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-20b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llava-next-34b
    # continuous batching: per-request channels, per-slot bottleneck modes
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --engine continuous --requests 8 --prompt-len 16 --gen 16
    # edge cluster: N replicas, mobility traces, live migration on handover
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --engine cluster --replicas 2 --placement best-channel \
        --handover migrate --requests 8 --n-slots 4 --telemetry
    # city fleet: Lumos5G trace lanes, Poisson arrivals, SLO admission,
    # autoscaling, a Chrome trace of the run
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --engine fleet --requests 64 --slo-ticks 96 --autoscale \
        --max-replicas 4 --trace-out fleet_trace.json
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
serves the full-attention archs (qwen2.5-3b, stablelm-3b, granite-8b,
internlm2-20b, the mixture of experts phi3.5-moe-42b-a6.6b, and the
frontend archs musicgen-large and llava-next-34b) from the paged pool,
and the windowed ones from the dense slot pool, whose rolling caches hold
``min(--cache-len, window)`` rows: mixtral-8x7b (experts and a 4096-token
sliding window), recurrentgemma-2b (RG-LRU and local-attention blocks)
and xlstm-125m (mLSTM and sLSTM blocks, whose carries do not depend on
it); the sync engine keeps one dense state of ``--requests`` rows. The
two MoE archs do not fit one 80 GB card in bf16 at their 32 layers (84
and 93 GB of weights): pass a config cut in depth to ``run_continuous``
/ ``run_sync`` (``chip_smoke.py`` serves 26 and 24 layers). musicgen-large's prompts are ``[K, S]``
codebook tokens from the Markov stream and it decodes K tokens a step;
llava-next-34b is served on text prompts (its vision prefix goes through
``T.prefill(embeddings=)``, not the engines, as in the reference).

The cluster and fleet engines run their replicas on the one device, over
one set of weights. ``--telemetry`` (or ``--trace-out``) attaches the
metrics registry and trace recorder: the summary then carries TTFT and
inter-token latency percentiles (``latency``, ms). ``--dp`` / ``--mp``
(the serving mesh) are not ported yet and raise.

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
from repro_torch.core.channel import (Channel, ChannelConfig, FleetChannel,
                                      MobilityChannel, channel_fleet)
from repro_torch.core.orchestrator import (AppRequirement, ModeProfile,
                                           Orchestrator)
from repro_torch.data.lumos5g import capacity_traces_bps
from repro_torch.data.tokens import MarkovTokenSource
from repro_torch.models import transformer as T
from repro_torch.serving import (HANDOVER_POLICIES, PLACEMENTS, Autoscaler,
                                 AutoscalerConfig, ContinuousBatchingEngine,
                                 ControllerConfig, EdgeCluster,
                                 FleetLoadConfig, ModeController, Request,
                                 ServingEngine, SLOAdmission,
                                 SLOAdmissionConfig, Telemetry,
                                 fleet_requests)
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


def _latency_section(tel) -> dict:
    """Millisecond percentile summary of the run's latency histograms
    (empty without --telemetry)."""
    if tel is None:
        return {}
    return {"latency": tel.registry.latency_summary(
        "engine.ttft_s", "engine.intertoken_s",
        "engine.admit_to_first_token_s", "cluster.migration_backhaul_s")}


def _timed_run(args, dev, run):
    """``run()`` between two device synchronizes, under the profiler when
    ``--profile-dir`` is given: (result, seconds, profiler or None)."""
    prof = make_profiler(args, dev)
    _sync(dev)
    t0 = time.perf_counter()
    with prof if prof is not None else contextlib.nullcontext():
        out = run()
        _sync(dev)
    return out, time.perf_counter() - t0, prof


def run_continuous(args, cfg, params, tel=None):
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
                                   cache_len=args.cache_len, telemetry=tel,
                                   **kw)
    # run every prefill batch bucket and window length once, so the
    # decode rate measures steady-state serving
    eng.warm(np.asarray(batch[0]))
    done, seconds, prof = _timed_run(args, dev, lambda: eng.run(reqs))
    st = eng.stats()
    return {
        "engine": "continuous",
        "device": str(dev),
        "n_slots": args.n_slots,
        "seconds": seconds,
        "decode_tok_per_s": st["decode_tokens"] / max(seconds, 1e-9),
        "per_request": [s.result() for s in done[:4]],
        "tokens": {s.request.rid: list(s.tokens) for s in done},
        **_latency_section(tel),
        **profile_extra(args, prof, seconds),
        **st,
    }


def run_cluster(args, cfg, params, tel=None):
    """Multi-replica edge cluster on scripted mobility: each UE starts in
    its home cell and crosses into the next cell partway through its
    generation, so every session exercises the configured handover policy
    (migrate / stay / drop) under the chosen placement."""
    dev = params["embed"]["table"].device
    n_rep = args.replicas
    cap_bps = args.mean_mbps * 1e6 / 8.0
    rng = np.random.default_rng(args.channel_seed)
    src = MarkovTokenSource(cfg, seed=7)
    batch = src.batch(args.requests, args.prompt_len)["tokens"]
    reqs = []
    for i in range(args.requests):
        home = i % n_rep
        cross = int(rng.integers(2, max(args.gen - 2, 3)))
        cells = [home] * cross + [(home + 1) % n_rep] * (args.gen + 8)
        ch = MobilityChannel(cells, [cap_bps] * n_rep,
                             detach_factor=args.detach_factor)
        reqs.append(Request(rid=i, prompt=np.asarray(batch[i]),
                            max_new_tokens=args.gen, channel=ch,
                            arrival_tick=i * args.arrival_every))
    cluster = EdgeCluster(
        params, cfg, n_replicas=n_rep, n_slots=args.n_slots,
        cache_len=args.cache_len, placement=args.placement,
        handover=args.handover, snapshot_bits=args.snapshot_bits,
        backhaul_bps=args.backhaul_mbps * 1e6 / 8.0,
        latency_budget_s=args.latency_budget_ms / 1e3,
        telemetry=tel)
    # warm every replica's paths so decode_tok_per_s measures steady-state
    # serving, as on the continuous engine
    cluster.warm(np.asarray(batch[0]))
    done, seconds, prof = _timed_run(args, dev, lambda: cluster.run(reqs))
    st = cluster.stats()
    cluster.close()
    return {
        "engine": "cluster",
        "device": str(dev),
        "seconds": seconds,
        "decode_tok_per_s": st["decode_tokens"] / max(seconds, 1e-9),
        "per_request": [s.result() for s in done[:4]],
        "tokens": {s.request.rid: list(s.tokens) for s in done},
        **_latency_section(tel),
        **profile_extra(args, prof, seconds),
        **st,
    }


def run_fleet(args, cfg, params, tel=None):
    """City-fleet serving: every UE rides one lane of a single vectorized
    ``FleetChannel`` replaying Lumos5G-resampled capacity traces, arrivals
    come from a Poisson or heavy-tail renewal process, and the elastic
    ``EdgeCluster`` applies SLO-driven admission plus replica
    autoscaling."""
    dev = params["embed"]["table"].device
    n = args.requests
    traces = capacity_traces_bps(n, 512, seed=args.channel_seed)
    fleet = FleetChannel(n, traces_bps=traces, cycle=True)
    load = FleetLoadConfig(arrival=args.arrival,
                           mean_interarrival_ticks=args.arrival_every,
                           prompt_len=args.prompt_len,
                           max_new_tokens=args.gen,
                           vocab=cfg.vocab_size,
                           slo_ticks=args.slo_ticks,
                           seed=args.channel_seed)
    reqs = fleet_requests(fleet, load)
    min_payload = min(bottleneck.mode_payload_bytes(cfg, 1, 1, m)
                      for m in range(cfg.split.n_modes))
    autoscaler = (Autoscaler(AutoscalerConfig(
        max_replicas=args.max_replicas)) if args.autoscale else None)
    cluster = EdgeCluster(
        params, cfg, n_replicas=args.replicas, n_slots=args.n_slots,
        cache_len=args.cache_len, placement="least-loaded",
        latency_budget_s=args.latency_budget_ms / 1e3,
        admission=SLOAdmission(min_payload, SLOAdmissionConfig(
            latency_budget_s=args.latency_budget_ms / 1e3)),
        autoscaler=autoscaler,
        telemetry=tel,
        max_pending=max(n, 64))
    cluster.warm(reqs[0].prompt)
    done, seconds, prof = _timed_run(args, dev,
                                     lambda: cluster.run_paced(reqs))
    st = cluster.stats()
    cluster.close()
    return {
        "engine": "fleet",
        "device": str(dev),
        "n_ues": n,
        "arrival": args.arrival,
        "autoscale": bool(args.autoscale),
        "seconds": seconds,
        "decode_tok_per_s": st["decode_tokens"] / max(seconds, 1e-9),
        "admission": cluster.admission.stats(),
        "per_request": [s.result() for s in done[:2]],
        "tokens": {s.request.rid: list(s.tokens) for s in done},
        **_latency_section(tel),
        **profile_extra(args, prof, seconds),
        **st,
    }


def run_sync(args, cfg, params, tel=None):
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
                        batch=args.requests, orchestrator=orch,
                        telemetry=tel)
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
        **({"latency": tel.registry.latency_summary(
            "engine_sync.prefill_s", "engine_sync.intertoken_s")}
           if tel is not None else {}),
        **profile_extra(args, prof, t_total),
        **stats,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS,
                    help="an arch of the port's registry: dense "
                         "(qwen2.5-3b, stablelm-3b, granite-8b, "
                         "internlm2-20b), mixture of experts "
                         "(phi3.5-moe-42b-a6.6b, mixtral-8x7b), audio "
                         "(musicgen-large), vision (llava-next-34b) or "
                         "recurrent (recurrentgemma-2b, xlstm-125m)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="sync",
                    choices=["sync", "continuous", "cluster", "fleet"],
                    help="sync: one static batch (the default); continuous: "
                         "continuous batching with per-slot modes; cluster: "
                         "N replicas with handover on scripted mobility; "
                         "fleet: Lumos5G trace lanes with SLO admission "
                         "and autoscaling (the serving mesh, --dp/--mp, "
                         "still raises)")
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
                    help="continuous engine: fleet mean uplink; cluster "
                         "engine: every cell's capacity")
    ap.add_argument("--replicas", type=int, default=2,
                    help="cluster / fleet engine: decoder replicas (one "
                         "per cell)")
    ap.add_argument("--placement", default="least-loaded",
                    choices=list(PLACEMENTS),
                    help="cluster engine: new-request routing policy")
    ap.add_argument("--handover", default="migrate",
                    choices=list(HANDOVER_POLICIES),
                    help="cluster engine: what to do when a UE crosses "
                         "cells mid-generation")
    ap.add_argument("--snapshot-bits", type=int, default=0,
                    help="cluster engine: quantize migration snapshots at "
                         "this bit width (0 = raw, bit-exact)")
    ap.add_argument("--backhaul-mbps", type=float, default=10000.0,
                    help="cluster engine: inter-replica backhaul for "
                         "migration snapshots")
    ap.add_argument("--detach-factor", type=float, default=0.05,
                    help="cluster engine: capacity multiplier while a UE "
                         "is served from the wrong cell")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "heavy-tail", "burst"],
                    help="fleet engine: arrival process of the load "
                         "generator")
    ap.add_argument("--slo-ticks", type=int, default=96,
                    help="fleet engine: session SLO in engine ticks "
                         "(arrival -> finish, queue wait included)")
    ap.add_argument("--autoscale", action="store_true",
                    help="fleet engine: attach the replica autoscaler")
    ap.add_argument("--max-replicas", type=int, default=8,
                    help="fleet engine: autoscaler ceiling")
    ap.add_argument("--dp", type=int, default=None,
                    help="serving mesh data-parallel axis (not ported yet: "
                         "raises)")
    ap.add_argument("--mp", type=int, default=None,
                    help="serving mesh tensor-parallel axis (not ported "
                         "yet: raises)")
    ap.add_argument("--telemetry", action="store_true",
                    help="attach the metrics registry + trace recorder "
                         "(latency percentiles land in the summary)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-loadable Chrome trace JSON here "
                         "(implies --telemetry)")
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
    if args.dp or args.mp:
        raise NotImplementedError(
            "--dp / --mp: the serving mesh is not ported yet (ROADMAP Queue "
            "1 item 7)")
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
    tel = Telemetry() if (args.telemetry or args.trace_out) else None
    runner = {"sync": run_sync, "continuous": run_continuous,
              "cluster": run_cluster, "fleet": run_fleet}[args.engine]
    summary = {"arch": args.arch, **runner(args, cfg, params, tel)}
    if args.trace_out and tel is not None:
        tel.trace.export(args.trace_out)
        summary["trace_out"] = args.trace_out
        summary["trace_events"] = len(tel.trace.events())
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
