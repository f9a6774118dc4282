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
inter-token latency percentiles (``latency``, ms).

``--dp`` / ``--mp`` serve on a mesh of ``dp * mp`` ranks (``--replicas``
times that for the cluster), one process a rank: the slots over dp; the
attention, MLP, MoE expert, RG-LRU and xLSTM layers over mp (each where
it divides, else replicated; ``sharding.check_model_parallel``). Under
``torchrun`` the launcher takes its environment; otherwise it starts the
ranks itself (``torch.multiprocessing``, spawn) and rank 0 prints.
``--dist-backend`` is nccl with ``--device cuda`` and gloo with ``--device
cpu`` unless given; rank r runs on ``cuda:r`` under ``--device cuda``,
and every rank on the one device under ``--device cuda:N`` (gloo only:
NCCL refuses two ranks on one device, and such a layout raises).

    # 4 gloo ranks on the CPU: 2-way dp x 2-way mp
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --reduced --device cpu --engine continuous --dp 2 --mp 2
    # the RG-LRU mixers over 2 ranks (the dense slot pool)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --reduced --device cpu --mp 2
    # on cards: torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
    #     --arch qwen2.5-3b --engine continuous --dp 2

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises rather than falling back to the CPU.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import datetime
import json
import os
import socket
import sys
import time
import traceback

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
from repro_torch.models import sharding
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


#: the CUDA runtime and driver calls that put work on the card: a kernel
#: launch (the hand-written kernels' cluster launch among them) or a CUDA
#: graph's
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")


def profile_summary(prof, seconds: float, top: int = 12) -> dict:
    """Device busy time of a ``torch.profiler`` run: the sum of its CUDA
    kernels' durations (one stream, so they do not overlap), the idle
    share of the wall time, the kernels that took the most time, the
    host's launch calls by name (``LAUNCH_CALLS``: one a kernel launched
    eagerly, one a CUDA graph replay), the graph replays' kernels, device
    busy time and span (a replay's first kernel's start to its last
    kernel's end, summed over the replays; a replayed kernel carries its
    ``cudaGraphLaunch``'s correlation id), and the calls and device time
    of ``aten::_to_copy`` (dtype casts, and the few host-to-device uploads
    of tokens and positions; its device time is that of the kernels
    launched by a cast or by an op nested in one, as ``key_averages``
    counts it). Read from the profiler's raw events: the ``FunctionEvent``
    tree of ``prof.events()`` costs far more host time than the run it
    describes at full width."""
    from torch.autograd import DeviceType
    by_name, kernels, ops, casts, calls = {}, [], {}, {}, {}
    graph_launches = set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
            kernels.append((e.linked_correlation_id(), e.correlation_id(),
                            e.start_ns(), e.end_ns()))
            continue
        if e.name() in LAUNCH_CALLS:
            calls[e.name()] = calls.get(e.name(), 0) + 1
            if e.name() == "cudaGraphLaunch":
                graph_launches.add(e.correlation_id())
        if e.linked_correlation_id() == 0:       # an op called on the host
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

    cast_ns = sum(end - start for linked, _, start, end in kernels
                  if linked in ops and in_cast(ops[linked]))
    replays = {}                # graph launch: kernels, busy, first, end
    for _, corr, start, end in kernels:
        if corr in graph_launches:
            n, busy, lo, hi = replays.get(corr, (0, 0, start, end))
            replays[corr] = (n + 1, busy + end - start, min(lo, start),
                             max(hi, end))
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": seconds, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / max(seconds, 1e-9),
            "kernel_launches": sum(n for _, n in by_name.values()),
            "launch_calls": calls,
            "graph_replays": {
                "replays": len(replays),
                "kernels": sum(r[0] for r in replays.values()),
                "busy_s": sum(r[1] for r in replays.values()) / 1e9,
                "span_s": sum(r[3] - r[2] for r in replays.values()) / 1e9},
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
    dev = _run_device(args, params)
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
                                   mesh=getattr(args, "mesh", None), **kw)
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
    dev = _run_device(args, params)
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
        telemetry=tel, **_cluster_mesh(args))
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
    dev = _run_device(args, params)
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
        max_pending=max(n, 64), **_cluster_mesh(args))
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
    dev = _run_device(args, params)
    orch = None
    if args.policy == "orchestrator":
        orch = build_orchestrator(cfg, args.requests,
                                  args.latency_budget_ms / 1e3)
    eng = ServingEngine(params, cfg, cache_len=args.cache_len,
                        batch=args.requests, orchestrator=orch,
                        telemetry=tel, mesh=getattr(args, "mesh", None))
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
            gen, wire = eng.decode_static(first, args.gen, mode)
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


def _run_device(args, params) -> torch.device:
    """The device a runner times on: the rank's on a mesh, else the
    weights'."""
    mesh_dev = getattr(args, "mesh_device", None)
    return mesh_dev if mesh_dev is not None else \
        params["embed"]["table"].device


def _cluster_mesh(args) -> dict:
    """EdgeCluster's mesh arguments under --dp / --mp, else none."""
    if not (args.dp or args.mp):
        return {}
    return {"dp": args.dp or 1, "mp": args.mp or 1,
            "devices": args.mesh_device}


def mesh_ranks(args) -> int:
    """Ranks a --dp / --mp run needs: dp * mp an engine, times the
    replicas of a cluster or fleet."""
    per = (args.dp or 1) * (args.mp or 1)
    return per * (args.replicas if args.engine in ("cluster", "fleet")
                  else 1)


def dist_backend(args) -> str:
    """--dist-backend, or nccl on cuda and gloo on the CPU."""
    if args.dist_backend:
        return args.dist_backend
    return "gloo" if torch.device(args.device).type == "cpu" else "nccl"


def check_layout(args, world: int) -> None:
    """Raise ``ValueError`` where the backend cannot run the layout (it is
    never swapped for another)."""
    backend = dist_backend(args)
    dev = torch.device(args.device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("--dist-backend nccl needs --device cuda; gloo runs "
                         "ranks on the CPU")
    if dev.type != "cuda":
        return
    if dev.index is not None and world > 1 and backend == "nccl":
        raise ValueError(
            f"NCCL cannot run {world} ranks on one device ({dev}): pass "
            f"--dist-backend gloo to share it, or --device cuda for one "
            f"card a rank")
    if dev.index is None and world > torch.cuda.device_count():
        raise ValueError(
            f"{world} ranks on cuda:<rank> need {world} cards, "
            f"{torch.cuda.device_count()} visible: pass --device cuda:0 "
            f"and --dist-backend gloo to share one")


def rank_device(args, rank: int) -> torch.device:
    """Rank r's device: cuda:r under --device cuda, the device named
    otherwise (CUDA without a card raises)."""
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


#: how long a rank waits in a collective before its group gives up
DIST_TIMEOUT = datetime.timedelta(seconds=600)


def _spawned_rank(entry, rank: int, world: int, port: int, backend: str,
                  argv, queue) -> None:
    """One rank started by :func:`spawn_ranks`: join the group, run
    ``entry(argv)``, hand rank 0's result (or any rank's error) back."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=DIST_TIMEOUT)
    try:
        out = entry(argv)
        if rank == 0:
            queue.put(("ok", out))
    except BaseException:
        queue.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def _first_result(queue, procs):
    """The first (status, result) a rank puts on ``queue``; raises if a
    rank dies without one (a crash puts nothing)."""
    import queue as queue_mod
    while True:
        try:
            return queue.get(timeout=5)
        except queue_mod.Empty:
            dead = [(i, p.exitcode) for i, p in enumerate(procs)
                    if not p.is_alive() and p.exitcode != 0]
            if dead:
                raise RuntimeError(f"ranks died without a result: {dead}")


def spawn_ranks(entry, argv, world: int, backend: str):
    """Start ``world`` ranks (``torch.multiprocessing``, spawn) over a
    ``tcp://localhost`` group, each running ``entry(argv)`` (a module-level
    function, which finds the group initialized); returns rank 0's result
    and raises if any rank failed. Every rank is joined before it
    returns."""
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_spawned_rank,
                         args=(entry, r, world, port, backend, argv, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        status, out = _first_result(queue, procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    if status != "ok":
        raise RuntimeError(f"a rank failed: {out}")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return out


def run_on_ranks(entry, args, argv, world: int, run):
    """``run()`` on this rank when ``torch.distributed`` is initialized;
    under ``torchrun``'s environment, after joining its group; else on
    ``world`` ranks started here, each calling ``entry(argv)``."""
    import torch.distributed as dist
    if dist.is_initialized():
        return run()
    backend = dist_backend(args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        check_layout(args, int(os.environ["WORLD_SIZE"]))
        dist.init_process_group(backend, init_method="env://",
                                timeout=DIST_TIMEOUT)
        try:
            return run()
        finally:
            dist.destroy_process_group()
    check_layout(args, world)
    return spawn_ranks(entry, argv, world, backend)


def serve_rank(args) -> dict:
    """This rank's part of a --dp / --mp run (the process group is up):
    its device and mesh, the run, and the kernel launches of every rank
    summed under ``mesh``. Rank 0 prints."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    rank, world = sharding.world()
    need = mesh_ranks(args)
    if world < need:
        raise ValueError(f"--dp {args.dp} --mp {args.mp} ({args.engine}) "
                         f"needs {need} ranks, the group has {world}")
    check_layout(args, world)
    dev = rank_device(args, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    args.mesh_device = dev
    args.mesh = (sharding.serving_mesh(args.dp or 1, args.mp or 1,
                                       device=dev)
                 if args.engine in ("continuous", "sync") else None)
    summary = _serve(args, dev, quiet=rank != 0)
    counts = ops.launch_counts()
    t = torch.tensor(list(counts.values()), dtype=torch.int64)
    if dist.get_backend() != "gloo":
        t = t.to(dev)
    dist.all_reduce(t)
    summary["mesh"] = {"dp": args.dp or 1, "mp": args.mp or 1,
                       "world": world, "rank": rank,
                       "backend": dist.get_backend(),
                       "launches": dict(zip(counts, t.tolist()))}
    if rank == 0:
        print(json.dumps({"mesh": summary["mesh"]}), flush=True)
    return summary


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
                         "and autoscaling")
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
                    help="serving mesh: data-parallel axis (slots over dp "
                         "ranks)")
    ap.add_argument("--mp", type=int, default=None,
                    help="serving mesh: tensor-parallel axis (heads, "
                         "d_ff, experts, RG-LRU channels and xLSTM heads "
                         "over mp ranks)")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="torch.distributed backend of a --dp / --mp run "
                         "(default nccl on cuda, gloo on the CPU)")
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
    if args.dp is not None or args.mp is not None:
        if min(v for v in (args.dp, args.mp) if v is not None) < 1:
            raise ValueError(f"mesh axes must be >= 1, got --dp {args.dp} "
                             f"--mp {args.mp}")
        return run_on_ranks(main, args,
                            sys.argv[1:] if argv is None else argv,
                            mesh_ranks(args), lambda: serve_rank(args))
    return _serve(args, resolve_device(args.device))


def _serve(args, dev, quiet: bool = False):
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if not quiet:
        print(f"== repro_torch.launch.serve {args.arch} "
              f"({'reduced' if args.reduced else 'FULL'}) on {dev} "
              f"engine={args.engine} "
              f"requests={args.requests} prompt={args.prompt_len} "
              f"gen={args.gen} ==", flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = SP.init_split_params(gen, cfg)
    if args.ckpt:
        params = checkpoint.restore(args.ckpt, params)
        if not quiet:
            print(f"loaded weights from {args.ckpt}", flush=True)
    tel = Telemetry() if (args.telemetry or args.trace_out) else None
    runner = {"sync": run_sync, "continuous": run_continuous,
              "cluster": run_cluster, "fleet": run_fleet}[args.engine]
    summary = {"arch": args.arch, **runner(args, cfg, params, tel)}
    if args.trace_out and tel is not None and not quiet:
        tel.trace.export(args.trace_out)
        summary["trace_out"] = args.trace_out
        summary["trace_events"] = len(tel.trace.events())
    # the generated tokens are returned, not printed
    printed = {k: v for k, v in summary.items() if k != "generated"
               and not (k == "tokens" and isinstance(v, dict))}
    if quiet:
        return summary
    print(json.dumps(printed, indent=1, default=str))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(printed, f, indent=1, default=str)
    return summary


if __name__ == "__main__":
    main()
