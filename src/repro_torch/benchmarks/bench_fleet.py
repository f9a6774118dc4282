"""City-scale fleet serving benchmark: UE scaling curve + autoscaler A/B
(the port of ``benchmarks/bench_fleet.py``; the same JSON keys).

Two experiments over the elastic ``EdgeCluster``:

1. **UE scaling curve** — the same fixed cluster serves fleets of
   growing size (default 100 / 1k / 10k UEs). Every fleet rides ONE
   vectorized :class:`~repro_torch.core.channel.FleetChannel` replaying
   Lumos5G-shaped capacity traces (no per-UE Python channel objects on
   the hot path), arrivals follow a heavy-tail renewal process packed
   into a fixed ~512-tick span — so offered load grows linearly with the
   fleet and the curve shows throughput saturating while the
   SLO-admission gate sheds the hopeless tail.

2. **Autoscaler A/B** — identical flash-crowd arrival waves served by
   (a) an autoscaled cluster growing from 1 replica and (b) a fixed
   cluster provisioned at the autoscaler's time-averaged replica count
   (equal aggregate slots). The headline ``autoscaler_wins`` — the
   elastic cluster must beat the equally-provisioned static one on
   ``session_slo_miss_rate`` — lands in ``--json``.

Runs the full-width config on ``cuda`` by default; ``--reduced`` takes the
reduced config and ``--device cpu`` the plain PyTorch path.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_fleet \
        [--arch qwen2.5-3b] [--reduced] [--device cpu] \
        [--ues 100,1000,10000] [--json out.json]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import bottleneck as BN
from repro_torch.core import split as SP
from repro_torch.core.channel import FleetChannel
from repro_torch.data.lumos5g import capacity_traces_bps
from repro_torch.serving import (Autoscaler, AutoscalerConfig, EdgeCluster,
                                 FleetLoadConfig, SLOAdmission,
                                 SLOAdmissionConfig, Telemetry,
                                 fleet_requests)
from repro_torch.serving.telemetry import Stopwatch

#: arrival span for the scaling sweep — offered load = n_ues / SPAN_TICKS
SPAN_TICKS = 512


def _min_payload(cfg) -> int:
    return min(BN.mode_payload_bytes(cfg, 1, 1, m)
               for m in range(cfg.split.n_modes))


def _make_fleet(n: int, *, n_ticks: int, seed: int) -> FleetChannel:
    traces = capacity_traces_bps(n, n_ticks, seed=seed)
    return FleetChannel(n, traces_bps=traces, cycle=True)


def _assert_conserved(st: dict):
    c = st["conservation"]
    terminals = (c["finished"] + c["queue_rejected_router"]
                 + c["queue_rejected_engine"] + c["over_capacity"]
                 + c["slo_rejected"])
    assert c["submitted"] == terminals and c["in_flight"] == 0, c


def mean_live_replicas(n0: int, scale_events, clock: int) -> float:
    """Time-averaged live replica count over the cluster clock — the
    autoscaled run's aggregate provisioning, which the fixed baseline
    must match (equal aggregate slots)."""
    n, last, area = n0, 0, 0.0
    for tick, kind, _ in scale_events:
        area += n * (tick - last)
        last = tick
        n += 1 if kind == "up" else -1
    area += n * (max(clock, last) - last)
    return area / max(clock, 1)


# ---------------------------------------------------------------------------
# experiment 1: UE scaling curve
# ---------------------------------------------------------------------------

def run_scaling(params, cfg, ue_counts, *, n_replicas: int, n_slots: int,
                prompt_len: int, gen: int, slo_ticks: int,
                seed: int = 0) -> list:
    rows = []
    min_pay = _min_payload(cfg)
    for n in ue_counts:
        fleet = _make_fleet(n, n_ticks=256, seed=seed)
        load = FleetLoadConfig(
            arrival="heavy-tail",
            mean_interarrival_ticks=SPAN_TICKS / n,
            prompt_len=prompt_len, max_new_tokens=gen,
            vocab=cfg.vocab_size, slo_ticks=slo_ticks, seed=seed)
        reqs = fleet_requests(fleet, load)
        gate = SLOAdmission(min_pay, SLOAdmissionConfig())
        tel = Telemetry()
        cluster = EdgeCluster(
            params, cfg, n_replicas=n_replicas, n_slots=n_slots,
            cache_len=max(32, 2 * (prompt_len + gen)),
            admission=gate, max_pending=max(256, 8 * n_slots),
            telemetry=tel)
        cluster.warm(reqs[0].prompt)
        with Stopwatch() as sw:
            cluster.run_paced(reqs)
        wall = sw.seconds
        st = cluster.stats()
        cluster.close()
        _assert_conserved(st)
        rows.append({
            "ues": n,
            "offered_req_per_tick": round(n / SPAN_TICKS, 3),
            "total_slots": n_replicas * n_slots,
            "finished": st["requests_finished"],
            "rejected": (st["requests_rejected"] + st["slo_rejected"]),
            "admission": gate.stats(),
            "decode_tok_per_s": round(
                st["decode_tokens"] / max(wall, 1e-9), 1),
            "session_slo_miss_rate": round(
                st["session_slo_miss_rate"], 4),
            "wall_s": round(wall, 2),
            "latency": tel.registry.latency_summary(
                "engine.ttft_s", "engine.intertoken_s",
                "engine.admit_to_first_token_s"),
        })
    return rows


# ---------------------------------------------------------------------------
# experiment 2: autoscaler vs fixed provisioning (equal aggregate slots)
# ---------------------------------------------------------------------------

def _wave_arrival_ticks(n: int, *, n_waves: int, period: int,
                        burst_len: int, bg_frac: float,
                        seed: int) -> np.ndarray:
    """Flash-crowd script: ``n_waves`` bursts ``period`` ticks apart, each
    spread over ``burst_len`` ticks, over a thin Poisson-ish background
    (the background keeps engines ticking between waves so the cluster
    clock tracks engine time and the autoscaler sees the lulls)."""
    rng = np.random.default_rng(seed)
    n_bg = int(n * bg_frac)
    n_wave, ticks = n - n_bg, []
    per = n_wave // n_waves
    for w in range(n_waves):
        c = per if w < n_waves - 1 else n_wave - per * (n_waves - 1)
        ticks.append(rng.integers(w * period, w * period + burst_len,
                                  size=c))
    ticks.append(rng.integers(0, n_waves * period, size=n_bg))
    return np.sort(np.concatenate(ticks)).astype(np.int64)


def run_autoscale_ab(params, cfg, *, n_ues: int, n_slots: int,
                     max_replicas: int, prompt_len: int, gen: int,
                     slo_ticks: int, seed: int = 0) -> dict:
    waves = _wave_arrival_ticks(n_ues, n_waves=3, period=160,
                                burst_len=64, bg_frac=0.2, seed=seed + 7)

    def _run(n_replicas: int, autoscale: bool) -> dict:
        fleet = _make_fleet(n_ues, n_ticks=256, seed=seed)
        load = FleetLoadConfig(arrival="burst", prompt_len=prompt_len,
                               max_new_tokens=gen, vocab=cfg.vocab_size,
                               slo_ticks=slo_ticks, seed=seed)
        reqs = fleet_requests(fleet, load)
        for r, t in zip(reqs, waves):    # identical wave script both arms
            r.arrival_tick = int(t)
        auto = Autoscaler(AutoscalerConfig(
            max_replicas=max_replicas, sustain_ticks=2, cooldown_ticks=4,
            high_occupancy=0.8)) if autoscale else None
        tel = Telemetry()
        cluster = EdgeCluster(params, cfg, n_replicas=n_replicas,
                              n_slots=n_slots,
                              cache_len=max(32, 2 * (prompt_len + gen)),
                              autoscaler=auto, max_pending=n_ues,
                              telemetry=tel)
        cluster.warm(reqs[0].prompt)
        with Stopwatch() as sw:
            cluster.run_paced(reqs)
        wall = sw.seconds
        st = cluster.stats()
        cluster.close()
        _assert_conserved(st)
        mean_live = mean_live_replicas(n_replicas, st["scale_events"],
                                       cluster.clock)
        return {
            "start_replicas": n_replicas,
            "mean_live_replicas": round(mean_live, 2),
            "aggregate_slots": round(mean_live * n_slots, 1),
            "scale_ups": st["scale_ups"],
            "scale_downs": st["scale_downs"],
            "finished": st["requests_finished"],
            "session_slo_late": st["session_slo_late"],
            "session_slo_miss_rate": round(
                st["session_slo_miss_rate"], 4),
            "decode_tok_per_s": round(
                st["decode_tokens"] / max(wall, 1e-9), 1),
            "latency": tel.registry.latency_summary(
                "engine.ttft_s", "engine.intertoken_s"),
        }

    auto = _run(1, autoscale=True)
    fixed_n = max(1, round(auto["mean_live_replicas"]))
    fixed = _run(fixed_n, autoscale=False)
    return {
        "ues": n_ues,
        "n_slots": n_slots,
        "max_replicas": max_replicas,
        "fixed_replicas": fixed_n,
        "autoscaled": auto,
        "fixed": fixed,
        # the acceptance claim: at equal aggregate slots, spending them
        # WHEN the flash crowd hits beats spreading them evenly
        "autoscaler_wins": bool(auto["session_slo_miss_rate"]
                                < fixed["session_slo_miss_rate"]),
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
    ap.add_argument("--ues", default="100,1000,10000",
                    help="comma list of fleet sizes for the scaling curve")
    ap.add_argument("--ab-ues", type=int, default=2000,
                    help="fleet size for the autoscaler A/B")
    ap.add_argument("--n-replicas", type=int, default=2,
                    help="fixed cluster size for the scaling curve")
    ap.add_argument("--n-slots", type=int, default=16)
    ap.add_argument("--max-replicas", type=int, default=6,
                    help="autoscaler ceiling in the A/B")
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--slo-ticks", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", "--json-out", dest="json_out", default=None,
                    metavar="PATH", help="write the full result dict as "
                    "JSON")
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import resolve_device
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = SP.init_split_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    ue_counts = [int(s) for s in args.ues.split(",")]
    print(f"== bench_fleet {args.arch} "
          f"({'reduced' if args.reduced else 'FULL'}) on {dev} "
          f"slots={args.n_slots} "
          f"gen={args.gen} ==", flush=True)

    scaling = run_scaling(params, cfg, ue_counts,
                          n_replicas=args.n_replicas,
                          n_slots=args.n_slots,
                          prompt_len=args.prompt_len, gen=args.gen,
                          slo_ticks=args.slo_ticks, seed=args.seed)
    for r in scaling:
        print(f"scaling,ues={r['ues']},offered={r['offered_req_per_tick']}"
              f"/tick,finished={r['finished']},rejected={r['rejected']},"
              f"tok/s={r['decode_tok_per_s']},"
              f"miss_rate={r['session_slo_miss_rate']},"
              f"wall={r['wall_s']}s")
        ttft = r["latency"].get("engine.ttft_s")
        itl = r["latency"].get("engine.intertoken_s")
        if ttft and itl:
            print(f"  latency,ues={r['ues']},"
                  f"ttft_ms=p50:{ttft['p50']}/p99:{ttft['p99']},"
                  f"intertoken_ms=p50:{itl['p50']}/p99:{itl['p99']}")

    ab = run_autoscale_ab(params, cfg, n_ues=args.ab_ues,
                          n_slots=args.n_slots,
                          max_replicas=args.max_replicas,
                          prompt_len=args.prompt_len, gen=args.gen,
                          slo_ticks=args.slo_ticks, seed=args.seed)
    for arm in ("autoscaled", "fixed"):
        r = ab[arm]
        print(f"ab,{arm},mean_live={r['mean_live_replicas']},"
              f"slots={r['aggregate_slots']},"
              f"miss_rate={r['session_slo_miss_rate']},"
              f"late={r['session_slo_late']},"
              f"tok/s={r['decode_tok_per_s']}")
    print(f"ab_summary,autoscaler_wins="
          f"{'yes' if ab['autoscaler_wins'] else 'no'}")

    out = {"arch": args.arch, "device": str(dev),
           "reduced": bool(args.reduced), "n_replicas": args.n_replicas,
           "n_slots": args.n_slots, "gen": args.gen,
           "slo_ticks": args.slo_ticks, "scaling": scaling,
           "autoscale_ab": ab}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
