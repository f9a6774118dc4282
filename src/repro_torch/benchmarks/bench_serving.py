"""Continuous-batching split-serving throughput vs offered load (the port
of ``benchmarks/bench_serving.py``; the same sections and JSON keys).

Sweeps the request arrival rate into ``ContinuousBatchingEngine`` and
reports, per offered-load level: decode tokens/s (engine wall clock),
uplink prefill wire bytes and decode wire-bytes/token, mean time-to-first-
token, slot occupancy, how often the decode batch was genuinely
*mixed-mode*, and (every level runs with telemetry) TTFT and inter-token
latency percentiles (``latency``, ms).

Also times the admission hot path head to head (batched full-sequence
prefill vs the token-at-a-time decode-step loop: ``prefill_comparison``),
the decode hot path (the device loop's windows against ``host_loop=True``,
which reads logits back every tick: ``engine_comparison``), the
telemetry subsystem's cost (``telemetry_overhead``), and on homogeneous
full-attention archs the long-prompt scenario (``long_prompt``: prompts
longer than the dense per-slot cache, which the dense engine rejects and
the paged engine finishes).

``--channel-trace {static,fade,burst}`` adds the paper's dynamic-adaptation
A/B (``channel_trace``): every session rides the *same* scripted capacity
trace (``TraceChannel``) under the adaptive ``ModeController`` and under
admission-frozen modes. ``--trace-out`` exports a Perfetto-loadable
Chrome trace of a small cluster run (SLO admission, a live migration and
the autoscaler on per-replica lanes: ``cluster_trace_export``).

``--slot-scaling 1,2,4`` adds the serving mesh's scenario
(``slot_scaling``): at each dp the slot pool grows to 2 x dp slots under a
saturating workload on dp ranks, dp 1 being the one-device engine. The
bench then runs on ``max(dps)`` ranks (started here, or ``torchrun``'s),
rank 0 running every other section and printing; ``--dist-backend`` as
in ``launch.serve``.

Runs the full-width config on ``cuda`` by default; ``--reduced`` takes the
reduced config and ``--device cpu`` the plain PyTorch path.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving \
        [--arch qwen2.5-3b] [--reduced] [--device cpu] \
        [--channel-trace fade] [--trace-out trace.json] [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import bottleneck as BN
from repro_torch.core import split as SP
from repro_torch.core.channel import (RTT_SECONDS, ChannelConfig,
                                      TraceChannel, channel_fleet)
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.serving import (ContinuousBatchingEngine, ControllerConfig,
                                 ModeController, Request, Telemetry,
                                 default_orchestrator)
from repro_torch.serving.telemetry import Stopwatch, best_of, block


def make_requests(cfg, n: int, *, prompt_len: int, gen: int,
                  arrival_every: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    chans = channel_fleet(
        n, ChannelConfig(mean_mbps=8.0, std_mbps=3.0, blockage_prob=0.08,
                         recovery_prob=0.15),
        seed=11 + seed, mean_spread=0.95)
    shape = ((cfg.n_codebooks, prompt_len)
             if cfg.frontend == "audio" and cfg.n_codebooks > 1
             else (prompt_len,))
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        size=shape).astype(np.int32),
                    max_new_tokens=gen, channel=chans[i],
                    arrival_tick=i * arrival_every)
            for i in range(n)]


def run_level(params, cfg, *, n_requests: int, arrival_every: int,
              n_slots: int, prompt_len: int, gen: int,
              host_loop: bool = False) -> dict:
    # every level runs instrumented: the per-level ``latency`` section
    # (p50/p90/p99 TTFT + inter-token) is a mandatory gated artifact, and
    # the telemetry_overhead A/B separately pins the instrumentation cost
    tel = Telemetry()
    eng = ContinuousBatchingEngine(params, cfg, n_slots=n_slots,
                                   cache_len=max(64, prompt_len + gen + 8),
                                   orchestrator=default_orchestrator(cfg),
                                   host_loop=host_loop, telemetry=tel)
    reqs = make_requests(cfg, n_requests, prompt_len=prompt_len, gen=gen,
                         arrival_every=arrival_every)
    # warm every compiled path the measured run can hit (decode + each
    # prefill batch bucket) so the throughput numbers measure the steady
    # state, not tracing
    eng.warm(reqs[0].prompt)

    with Stopwatch() as sw:
        done = eng.run(reqs)
    wall = sw.seconds
    st = eng.stats()
    eng.close()
    occupancy = st["decode_tokens"] / max(st["decode_ticks"] * n_slots, 1)
    paged = {}
    if st["paged"]:
        paged = {
            "page_len": st["page_len"],
            "n_pages": st["n_pages"],
            "peak_pages_in_use": st["peak_pages_in_use"],
            "page_occupancy": st["page_occupancy"],
            "requests_parked": st["requests_parked"],
        }
    return {
        "paged": st["paged"],
        **paged,
        "offered_load_req_per_tick": round(1.0 / arrival_every, 3),
        "requests": n_requests,
        "finished": st["requests_finished"],
        "rejected": st["requests_rejected"],
        "over_capacity": st["requests_over_capacity"],
        "truncated": st["requests_truncated"],
        "decode_tok_per_s": round(st["decode_tokens"] / max(wall, 1e-9), 1),
        "prefill_wire_bytes": st["prefill_wire_bytes"],
        "decode_wire_bytes_per_token": round(
            st["decode_wire_bytes_per_token"], 1),
        "mean_ttft_ms": round(1e3 * st["mean_ttft_s"], 2),
        "prefill_calls": st["prefill_calls"],
        "prefill_tokens": st["prefill_tokens"],
        "prefill_tok_per_s": round(st["prefill_tokens"] / max(wall, 1e-9), 1),
        "mode_counts": st["mode_counts"],
        "mixed_mode_ticks": st["mixed_mode_ticks"],
        "decode_ticks": st["decode_ticks"],
        "slot_occupancy": round(occupancy, 3),
        "mean_transfer_ms_per_token": round(
            1e3 * float(np.mean([s.transfer_s / max(len(s.tokens), 1)
                                 for s in done])), 3) if done else 0.0,
        # gated artifact: ms p50/p90/p99/max per latency histogram
        "latency": tel.registry.latency_summary(
            "engine.ttft_s", "engine.intertoken_s",
            "engine.admit_to_first_token_s"),
    }


def run_long_prompt(params, cfg, *, n_slots: int, gen: int,
                    cache_len: int = 24, n_requests: int = 4) -> dict:
    """The paged pool's headline scenario: every prompt is LONGER than the
    dense per-slot cache, so the legacy ``SlotPool`` engine rejects all of
    them over capacity — the paged engine must admit and FINISH every one
    with zero capacity rejections and zero truncation, parking excess
    sessions until page-budget admission can cover their worst case.

    Reports the paged engine's decode throughput and page-arena occupancy
    plus the dense control's rejection count."""
    prompt_len = cache_len + 8                 # > dense per-slot capacity
    eng = ContinuousBatchingEngine(params, cfg, n_slots=n_slots,
                                   cache_len=cache_len,
                                   orchestrator=default_orchestrator(cfg))
    assert eng.paged, "long-prompt scenario needs the paged pool"
    reqs = make_requests(cfg, n_requests, prompt_len=prompt_len, gen=gen,
                         arrival_every=2)
    eng.warm(reqs[0].prompt)
    t0 = time.time()
    eng.run(reqs)
    wall = time.time() - t0
    st = eng.stats()
    eng.close()

    dense = ContinuousBatchingEngine(params, cfg, n_slots=n_slots,
                                     cache_len=cache_len, paged=False)
    dense.run(make_requests(cfg, n_requests, prompt_len=prompt_len,
                            gen=gen, arrival_every=2))
    dense_st = dense.stats()
    dense.close()
    return {
        "prompt_len": prompt_len,
        "dense_cache_len": cache_len,
        "gen": gen,
        "requests": n_requests,
        "finished": st["requests_finished"],
        "over_capacity": st["requests_over_capacity"],
        "truncated": st["requests_truncated"],
        "requests_parked": st["requests_parked"],
        "decode_tok_per_s": round(st["decode_tokens"] / max(wall, 1e-9), 1),
        "page_len": st["page_len"],
        "n_pages": st["n_pages"],
        "peak_pages_in_use": st["peak_pages_in_use"],
        "page_occupancy": st["page_occupancy"],
        "dense_over_capacity": dense_st["requests_over_capacity"],
        "dense_finished": dense_st["requests_finished"],
    }


def compare_engine_loops(params, cfg, *, n_slots: int, prompt_len: int,
                         gen: int, n_requests: int, repeats: int = 4) -> dict:
    """Decode throughput of the windowed device loop vs the host loop
    (``host_loop=True``: logits and argmax read back every tick) on an
    identical saturating workload. The two decode token-identical streams,
    so the speedup is hot-path overhead removal: the fused tail's token fed
    back on the device and the one-window-lagged host read.

    Runs are interleaved host/device/host/device and each side reports its
    best repeat, so machine-load drift hits both engines symmetrically."""
    engines = {}
    for key, host_loop in [("host_loop", True), ("device_loop", False)]:
        eng = ContinuousBatchingEngine(
            params, cfg, n_slots=n_slots,
            cache_len=max(64, prompt_len + gen + 8),
            orchestrator=default_orchestrator(cfg), host_loop=host_loop)
        # decode-dominated workload: every request present at tick 0 with
        # short prompts and a long generation, so wall clock measures the
        # per-tick loop, not admission
        eng.warm(make_requests(cfg, 1, prompt_len=prompt_len, gen=gen,
                               arrival_every=0)[0].prompt)
        engines[key] = eng
    out = {k: {"decode_tok_per_s": 0.0} for k in engines}
    for _ in range(repeats):
        for key, eng in engines.items():
            eng.reset_counters()
            reqs = make_requests(cfg, n_requests, prompt_len=prompt_len,
                                 gen=gen, arrival_every=0)
            t0 = time.perf_counter()
            eng.run(reqs)
            wall = time.perf_counter() - t0
            st = eng.stats()
            rate = round(st["decode_tokens"] / max(wall, 1e-9), 1)
            if rate > out[key]["decode_tok_per_s"]:
                out[key] = {
                    "decode_tok_per_s": rate,
                    "decode_ticks": st["decode_ticks"],
                    "slot_occupancy": round(
                        st["decode_tokens"]
                        / max(st["decode_ticks"] * n_slots, 1), 3),
                }
    for eng in engines.values():
        eng.close()
    out["n_slots"] = n_slots
    out["gen"] = gen
    out["requests"] = n_requests
    out["repeats"] = repeats
    out["decode_speedup"] = round(
        out["device_loop"]["decode_tok_per_s"]
        / max(out["host_loop"]["decode_tok_per_s"], 1e-9), 2)
    return out


def run_slot_scaling(params, cfg, *, dps, n_slots_base: int = 2,
                     prompt_len: int = 4, gen: int = 16,
                     device=None) -> dict:
    """Slot scaling over the serving mesh (the reference's
    ``run_slot_scaling``): at each dp the slot pool grows to
    ``n_slots_base * dp`` (each dp shard holds the base slot count) and a
    saturating workload (every request present at tick 0, 2x
    oversubscribed) measures decode tok/s on the leader's clock. dp 1 is
    the one-device ``mesh=None`` engine on rank 0. Call on every rank of
    the process group (a mesh is built collectively); dp values above the
    world size are skipped and listed in ``skipped_dps``. Ranks sharing
    one card measure completion and launches, not dp speed."""
    rank, size = sharding.world()
    rows, skipped = [], []
    for dp in dps:
        if dp > size:
            skipped.append(dp)
            continue
        mesh = (sharding.serving_mesh(dp, 1, device=device) if dp > 1
                else None)
        if (rank != 0) if mesh is None else not mesh.member:
            _barrier()
            continue
        n_slots = n_slots_base * dp
        eng = ContinuousBatchingEngine(
            params, cfg, n_slots=n_slots,
            cache_len=max(64, prompt_len + gen + 8),
            orchestrator=default_orchestrator(cfg), mesh=mesh)
        reqs = make_requests(cfg, 2 * n_slots, prompt_len=prompt_len,
                             gen=gen, arrival_every=0)
        eng.warm(reqs[0].prompt)
        # one untimed round of the real admission pattern first
        eng.run(make_requests(cfg, 2 * n_slots, prompt_len=prompt_len,
                              gen=gen, arrival_every=0))
        eng.reset_counters()
        dev = eng.device
        block(torch.zeros((), device=dev))
        t0 = time.perf_counter()
        eng.run(reqs)
        block(eng.cur_tokens)
        wall = time.perf_counter() - t0
        st = eng.stats()
        eng.close()
        rows.append({
            "dp": dp,
            "n_slots": n_slots,
            "requests": 2 * n_slots,
            "finished": st["requests_finished"],
            "decode_tok_per_s": round(
                st["decode_tokens"] / max(wall, 1e-9), 1),
            "decode_ticks": st["decode_ticks"],
            "slot_occupancy": round(
                st["decode_tokens"]
                / max(st["decode_ticks"] * n_slots, 1), 3),
        })
        _barrier()
    if skipped and rank == 0:
        print(f"slot_scaling: skipped dp={skipped} (only {size} ranks)")
    return {"n_slots_base": n_slots_base, "gen": gen, "n_ranks": size,
            "rows": rows, "skipped_dps": skipped}


def _barrier():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def run_telemetry_overhead(params, cfg, *, n_slots: int, prompt_len: int,
                           gen: int, n_requests: int,
                           repeats: int = 4) -> dict:
    """Decode throughput with the telemetry subsystem attached vs a plain
    engine on an identical saturating device-loop workload. The telemetry
    engine carries the full instrumentation: registry histograms, trace
    spans, and the per-tick int32 telemetry block of each window. Token
    streams are bit-identical either way; this measures only the
    overhead.

    Runs are interleaved plain/telemetry/plain/telemetry and each side
    keeps its best repeat, so machine-load drift hits both symmetrically
    (the same protocol as ``compare_engine_loops``)."""
    engines = {}
    for key in ("plain", "telemetry"):
        eng = ContinuousBatchingEngine(
            params, cfg, n_slots=n_slots,
            cache_len=max(64, prompt_len + gen + 8),
            orchestrator=default_orchestrator(cfg),
            telemetry=Telemetry() if key == "telemetry" else None)
        eng.warm(make_requests(cfg, 1, prompt_len=prompt_len, gen=gen,
                               arrival_every=0)[0].prompt)
        engines[key] = eng
    best = {k: 0.0 for k in engines}
    for _ in range(repeats):
        for key, eng in engines.items():
            eng.reset_counters()
            reqs = make_requests(cfg, n_requests, prompt_len=prompt_len,
                                 gen=gen, arrival_every=0)
            t0 = time.perf_counter()
            eng.run(reqs)
            wall = time.perf_counter() - t0
            st = eng.stats()
            best[key] = max(best[key],
                            st["decode_tokens"] / max(wall, 1e-9))
    for eng in engines.values():
        eng.close()
    return {
        "n_slots": n_slots,
        "gen": gen,
        "requests": n_requests,
        "repeats": repeats,
        "plain_tok_per_s": round(best["plain"], 1),
        "telemetry_tok_per_s": round(best["telemetry"], 1),
        "ratio": round(best["telemetry"] / max(best["plain"], 1e-9), 3),
    }


def export_cluster_trace(params, cfg, path: str, *, n_requests: int = 5,
                         gen: int = 10) -> dict:
    """Run a small cluster exercising every control-plane event source —
    SLO admission, a scripted mid-generation handover (live migration),
    and the autoscaler — with telemetry attached, and export the merged
    per-replica-lane Chrome trace to ``path`` (loadable in Perfetto).
    Returns event counts so the artifact's coverage is auditable."""
    from repro_torch.core.channel import MobilityChannel
    from repro_torch.serving import (Autoscaler, AutoscalerConfig,
                                     EdgeCluster, SLOAdmission)
    tel = Telemetry()
    rng = np.random.default_rng(0)

    def mobility(cross_at):
        cells = [0] * cross_at + [1] * (gen + 60)
        return MobilityChannel(cells, [2e6, 2e6], detach_factor=1.0)

    cluster = EdgeCluster(
        params, cfg, n_replicas=2, n_slots=2, cache_len=gen + 24,
        placement="best-channel", handover="migrate",
        admission=SLOAdmission(min_payload_bytes=64),
        autoscaler=Autoscaler(AutoscalerConfig(
            min_replicas=1, max_replicas=4, high_occupancy=0.5,
            sustain_ticks=1, cooldown_ticks=2)),
        telemetry=tel)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        size=4).astype(np.int32),
                    max_new_tokens=gen,
                    channel=mobility(5 if i == 0 else gen + 50),
                    slo_ticks=400)
            for i in range(n_requests)]
    cluster.run(reqs)
    cluster.stats()
    cluster.close()
    tel.trace.export(path)
    counts = {}
    for ev in tel.trace.events():
        counts[ev["name"]] = counts.get(ev["name"], 0) + 1
    lanes = sorted({ev["pid"] for ev in tel.trace.events()})
    return {"path": path, "events": len(tel.trace.events()),
            "dropped": tel.trace.dropped, "lanes": lanes,
            "event_counts": counts}


def build_capacity_trace(kind: str, n_ticks: int, hi_bps: float,
                         lo_bps: float, period: int = 8) -> np.ndarray:
    """Scripted capacity traces (bytes/s per tick) for the adaptive-vs-frozen
    A/B. ``static``: constant good link (sanity — the policies must tie).
    ``fade``: good link at admission, smooth mmWave fade to ``lo``, stays
    low (the motivating scenario: a session admitted on a good link whose
    beam then degrades). ``burst``: LoS/NLoS blockage bursts alternating
    ``hi``/``lo`` every ``period/2`` ticks."""
    if kind == "static":
        return np.full(n_ticks, hi_bps)
    if kind == "fade":
        head = np.full(max(n_ticks // 8, 2), hi_bps)
        ramp = np.linspace(hi_bps, lo_bps, max(n_ticks // 4, 2))
        tail = np.full(max(n_ticks - head.size - ramp.size, 1), lo_bps)
        return np.concatenate([head, ramp, tail])[:n_ticks]
    if kind == "burst":
        t = np.arange(n_ticks)
        return np.where((t % period) < period // 2, hi_bps, lo_bps)
    raise ValueError(f"unknown trace kind {kind!r}")


def run_channel_trace(params, cfg, kind: str, *, n_slots: int, gen: int,
                      prompt_len: int, latency_budget_s: float = 0.006,
                      seed: int = 0) -> dict:
    """Adaptive (ModeController) vs admission-frozen modes on IDENTICAL
    scripted channels: same prompts, same capacity at every channel tick —
    the only degree of freedom is the per-tick mode policy."""
    pay = {m: BN.mode_payload_bytes(cfg, 1, 1, m)
           for m in range(cfg.split.n_modes)}
    # capacity levels derived from the calibrated payloads so the scenario
    # transfers across archs: hi = every mode comfortably feasible,
    # lo = only the cheapest mode fits the per-token transmit budget
    transmit = max(latency_budget_s - RTT_SECONDS, 1e-4)
    hi = 4.0 * max(pay.values()) / transmit
    lo = 1.3 * min(pay.values()) / transmit
    trace = build_capacity_trace(kind, gen + 8, hi, lo)
    rng = np.random.default_rng(seed)
    shape = ((cfg.n_codebooks, prompt_len)
             if cfg.frontend == "audio" and cfg.n_codebooks > 1
             else (prompt_len,))
    prompts = [rng.integers(1, cfg.vocab_size, size=shape).astype(np.int32)
               for _ in range(n_slots)]

    def run(policy: str) -> dict:
        orch = default_orchestrator(cfg, latency_budget_s, hysteresis=0.9)
        kw = ({"controller": ModeController(orch,
                                            ControllerConfig(dwell_ticks=2))}
              if policy == "adaptive"
              else {"orchestrator": orch, "freeze_modes": True})
        eng = ContinuousBatchingEngine(
            params, cfg, n_slots=n_slots,
            cache_len=max(64, prompt_len + gen + 8), **kw)
        # all sessions admitted at tick 0 on the trace's opening capacity —
        # the frozen baseline locks in whatever that admission capacity buys
        reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=gen,
                        channel=TraceChannel(trace))
                for i in range(n_slots)]
        eng.warm(prompts[0], gen=2)
        done = eng.run(reqs)
        st = eng.stats()
        eng.close()
        assert len(done) == n_slots
        return {
            "decode_wire_bytes_per_token": round(
                st["decode_wire_bytes_per_token"], 2),
            "deadline_miss_rate": round(st["deadline_miss_rate"], 4),
            "deadline_misses": st["deadline_misses"],
            "mode_switches": st["mode_switches"],
            "mode_escalations": st["mode_escalations"],
            "mode_counts": st["mode_counts"],
        }

    adaptive, frozen = run("adaptive"), run("frozen")
    saved = 1.0 - (adaptive["decode_wire_bytes_per_token"]
                   / max(frozen["decode_wire_bytes_per_token"], 1e-9))
    return {
        "trace": kind,
        "n_slots": n_slots,
        "gen": gen,
        "capacity_hi_bps": round(hi, 1),
        "capacity_lo_bps": round(lo, 1),
        "adaptive": adaptive,
        "frozen": frozen,
        "wire_savings_pct": round(100.0 * saved, 1),
        # the acceptance claim: fewer wire bytes/token at an equal-or-better
        # deadline-miss rate (ties allowed — `static` should tie exactly)
        "adaptive_wins": bool(
            adaptive["decode_wire_bytes_per_token"]
            <= frozen["decode_wire_bytes_per_token"]
            and adaptive["deadline_miss_rate"]
            <= frozen["deadline_miss_rate"]),
    }


def time_prefill_paths(params, cfg, *, prompt_len: int, cache_len: int,
                       repeats: int = 3) -> dict:
    """Time-to-first-token, batched full-sequence prefill vs the
    token-at-a-time decode-step loop (both run once before timing; each
    timed call ends in a device synchronize)."""
    rng = np.random.default_rng(0)
    dev = params["embed"]["table"].device
    p = T.prepare_params(params, cfg)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(1, prompt_len)).astype(np.int32)).to(dev)
    lens = torch.tensor([prompt_len], dtype=torch.int32, device=dev)

    def loop_once():
        states = T.init_decode_state(cfg, 1, cache_len, device=dev)
        logits = None
        for t in range(prompt_len):
            logits, states = T.decode_step(p, prompt[:, t:t + 1], states, t,
                                           cfg)
        out = torch.argmax(logits, -1)
        block(out)
        return out

    def batched_once():
        states = T.init_decode_state(cfg, 1, cache_len, device=dev)
        logits, _ = T.prefill(p, prompt, cfg, states, lengths=lens)
        out = torch.argmax(logits, -1)
        block(out)
        return out

    loop_once(), batched_once()            # first calls
    t_loop, _ = best_of(loop_once, repeats=repeats)
    t_batched, _ = best_of(batched_once, repeats=repeats)
    return {
        "prompt_len": prompt_len,
        "ttft_loop_ms": round(1e3 * t_loop, 3),
        "ttft_batched_ms": round(1e3 * t_batched, 3),
        "ttft_speedup": round(t_loop / max(t_batched, 1e-9), 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (default: full width)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--loads", default="8,2,1",
                    help="comma list of arrival spacings (ticks/request); "
                         "smaller = heavier offered load")
    ap.add_argument("--prefill-prompt-len", type=int, default=64,
                    help="prompt length for the batched-vs-loop TTFT "
                         "comparison")
    ap.add_argument("--compare-slots", type=int, default=8,
                    help="slot-pool size for the device-loop vs host-loop "
                         "decode throughput A/B (0 disables it)")
    ap.add_argument("--compare-gen", type=int, default=24,
                    help="decode tokens per request in the loop A/B")
    ap.add_argument("--slot-scaling", default=None, metavar="DPS",
                    help="comma list of dp mesh factors: the slot-scaling "
                         "scenario over the serving mesh, on max(DPS) "
                         "ranks")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="torch.distributed backend of --slot-scaling "
                         "(default nccl on cuda, gloo on the CPU)")
    ap.add_argument("--channel-trace", default=None,
                    choices=["static", "fade", "burst"],
                    help="run the adaptive-vs-frozen mode-policy A/B on a "
                         "scripted capacity trace")
    ap.add_argument("--trace-gen", type=int, default=24,
                    help="decode tokens per session in the --channel-trace "
                         "scenario (long enough to span the fade)")
    ap.add_argument("--overhead-repeats", type=int, default=4,
                    help="repeats for the telemetry-on vs -off decode "
                         "throughput A/B (0 disables the section)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export a Perfetto-loadable Chrome trace from a "
                         "small cluster run (admission + migration + "
                         "autoscale events on per-replica lanes)")
    ap.add_argument("--json", "--json-out", dest="json_out", default=None,
                    metavar="PATH", help="write the full result dict as JSON")
    args = ap.parse_args(argv)
    from repro_torch.launch import serve
    if args.slot_scaling:
        dps = [int(v) for v in args.slot_scaling.split(",")]
        return serve.run_on_ranks(
            main, args, sys.argv[1:] if argv is None else argv, max(dps),
            lambda: _bench(args, dps))
    return _bench(args, None)


def _bench(args, dps):
    from repro_torch.launch import serve
    rank = sharding.world()[0]
    if dps is None:
        dev = serve.resolve_device(args.device)
    else:
        dev = serve.rank_device(args, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = SP.init_split_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    out = {"arch": args.arch, "n_slots": args.n_slots, "device": str(dev),
           "reduced": bool(args.reduced)}
    if rank == 0:
        out.update(_sections(args, cfg, params, dev))
    if dps:
        sc = run_slot_scaling(params, cfg, dps=dps,
                              prompt_len=args.prompt_len, device=dev)
        out["slot_scaling"] = sc
        for row in sc["rows"] if rank == 0 else ():
            print(f"slot_scaling,dp={row['dp']},slots={row['n_slots']},"
                  f"tok/s={row['decode_tok_per_s']} "
                  f"finished={row['finished']}/{row['requests']} "
                  f"occ={row['slot_occupancy']}")
    if args.json_out and rank == 0:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


def _sections(args, cfg, params, dev) -> dict:
    """Every section but the slot scaling (rank 0's)."""
    print(f"== bench_serving {args.arch} "
          f"({'reduced' if args.reduced else 'FULL'}) on {dev} "
          f"slots={args.n_slots} requests={args.requests} gen={args.gen} ==",
          flush=True)

    pf = time_prefill_paths(params, cfg,
                            prompt_len=args.prefill_prompt_len,
                            cache_len=max(128, args.prefill_prompt_len + 8))
    print(f"prefill,prompt={pf['prompt_len']},"
          f"ttft_loop_ms={pf['ttft_loop_ms']} "
          f"ttft_batched_ms={pf['ttft_batched_ms']} "
          f"speedup={pf['ttft_speedup']}x")

    levels = []
    for spacing in [int(s) for s in args.loads.split(",")]:
        r = run_level(params, cfg, n_requests=args.requests,
                      arrival_every=spacing, n_slots=args.n_slots,
                      prompt_len=args.prompt_len, gen=args.gen)
        levels.append(r)
        print(f"serving,load={r['offered_load_req_per_tick']},"
              f"tok/s={r['decode_tok_per_s']} "
              f"decode_wireB/tok={r['decode_wire_bytes_per_token']} "
              f"prefill_wireB={r['prefill_wire_bytes']} "
              f"ttft_ms={r['mean_ttft_ms']} "
              f"prefills={r['prefill_calls']} "
              f"occ={r['slot_occupancy']} "
              f"mixed={r['mixed_mode_ticks']}/{r['decode_ticks']} "
              f"modes={r['mode_counts']}")
        lat = r["latency"]
        for name, p in lat.items():
            print(f"  latency,{name}: p50={p['p50']}ms p90={p['p90']}ms "
                  f"p99={p['p99']}ms max={p['max']}ms n={p['count']}")

    lp = None
    if T.full_attention_arch(cfg) and cfg.homogeneous:
        lp = run_long_prompt(params, cfg, n_slots=args.n_slots, gen=args.gen)
        print(f"long_prompt,prompt={lp['prompt_len']}"
              f">{lp['dense_cache_len']}=dense_cache,"
              f"finished={lp['finished']}/{lp['requests']} "
              f"over_capacity={lp['over_capacity']} "
              f"parked={lp['requests_parked']} "
              f"tok/s={lp['decode_tok_per_s']} "
              f"pages={lp['peak_pages_in_use']}/{lp['n_pages']} "
              f"dense_rejects={lp['dense_over_capacity']}/{lp['requests']}")

    mixed_any = any(r["mixed_mode_ticks"] > 0 for r in levels)
    print(f"serving_summary,mixed_mode_batches={'yes' if mixed_any else 'no'},"
          f"levels={len(levels)},prefill_speedup={pf['ttft_speedup']}x")
    out = {"prefill_comparison": pf, "levels": levels}
    if lp is not None:
        out["long_prompt"] = lp

    if args.compare_slots:
        ec = compare_engine_loops(
            params, cfg, n_slots=args.compare_slots,
            prompt_len=args.prompt_len, gen=args.compare_gen,
            n_requests=max(args.requests, 2 * args.compare_slots))
        out["engine_comparison"] = ec
        print(f"engine_comparison,slots={ec['n_slots']},"
              f"device_tok/s={ec['device_loop']['decode_tok_per_s']} "
              f"host_tok/s={ec['host_loop']['decode_tok_per_s']} "
              f"decode_speedup={ec['decode_speedup']}x")

    if args.overhead_repeats:
        ov = run_telemetry_overhead(
            params, cfg, n_slots=args.n_slots, prompt_len=args.prompt_len,
            gen=args.compare_gen,
            n_requests=max(args.requests, 2 * args.n_slots),
            repeats=args.overhead_repeats)
        out["telemetry_overhead"] = ov
        print(f"telemetry_overhead,plain_tok/s={ov['plain_tok_per_s']} "
              f"telemetry_tok/s={ov['telemetry_tok_per_s']} "
              f"ratio={ov['ratio']}")

    if args.trace_out:
        ct = export_cluster_trace(params, cfg, args.trace_out)
        out["cluster_trace_export"] = ct
        print(f"cluster_trace,events={ct['events']} "
              f"lanes={ct['lanes']} -> {ct['path']}")

    if args.channel_trace:
        tr = run_channel_trace(params, cfg, args.channel_trace,
                               n_slots=args.n_slots, gen=args.trace_gen,
                               prompt_len=args.prompt_len)
        out["channel_trace"] = tr
        print(f"channel_trace,{tr['trace']},"
              f"adaptive_wireB/tok={tr['adaptive']['decode_wire_bytes_per_token']} "
              f"frozen_wireB/tok={tr['frozen']['decode_wire_bytes_per_token']} "
              f"saved={tr['wire_savings_pct']}% "
              f"miss_adaptive={tr['adaptive']['deadline_miss_rate']} "
              f"miss_frozen={tr['frozen']['deadline_miss_rate']} "
              f"switches={tr['adaptive']['mode_switches']} "
              f"adaptive_wins={'yes' if tr['adaptive_wins'] else 'no'}")
    return out


if __name__ == "__main__":
    main()
