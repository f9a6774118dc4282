"""Edge-cluster serving benchmark: handover policies + replica scaling
(the port of ``benchmarks/bench_cluster.py``; the same JSON keys).

Two experiments over ``EdgeCluster`` (multi-replica split serving with
mmWave cell handover):

1. **Handover A/B** — every session rides the *identical* scripted
   cell-crossing ``MobilityChannel`` (same cells, same capacities, same
   crossing tick) under three policies: ``migrate`` (live state migration
   over the simulated backhaul), ``stay`` (keep decoding on the old cell's
   replica at ``detach_factor`` capacity), and ``drop`` (drop-and-replay
   the full context on the new replica). Capacity levels derive from the
   calibrated mode payloads so the scenario transfers across archs: in-cell
   capacity makes every mode comfortably feasible, detached capacity makes
   even the cheapest mode blow the latency budget — staying *must* miss
   deadlines, which is exactly what migration buys back. The headline
   ``migration_wins`` (migrate beats stay on deadline-miss rate) lands in
   ``--json``, alongside wire bytes/token, migration backhaul bytes (raw
   vs quantized snapshots), and handover latency.

2. **Replica scaling** — a fixed offered load served by 1, 2, ... replica
   clusters; reports aggregate decode tokens/s per replica count. The
   replicas tick in turn on one host thread and one CUDA stream (the
   reference gives each its own pipeline thread), so on a host-bound card
   the aggregate stays near one engine's rate.

Runs the full-width config on ``cuda`` by default; ``--reduced`` takes the
reduced config and ``--device cpu`` the plain PyTorch path.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_cluster \
        [--arch qwen2.5-3b] [--reduced] [--device cpu] [--replicas 1,2] \
        [--json out.json]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core import bottleneck as BN
from repro_torch.core import split as SP
from repro_torch.core.channel import RTT_SECONDS, MobilityChannel
from repro_torch.serving import EdgeCluster, Request


def _capacities(cfg, latency_budget_s: float):
    """(in-cell, detached) capacity in bytes/s, derived from the calibrated
    mode payloads: in-cell fits every mode in the per-token transmit
    budget; detached does not fit even the cheapest."""
    pay = [BN.mode_payload_bytes(cfg, 1, 1, m)
           for m in range(cfg.split.n_modes)]
    transmit = max(latency_budget_s - RTT_SECONDS, 1e-4)
    hi = 4.0 * max(pay) / transmit
    lo = 0.5 * min(pay) / transmit
    return hi, lo


def make_mobility_requests(cfg, n: int, *, n_cells: int, prompt_len: int,
                           gen: int, cap_bps: float, detach_factor: float,
                           seed: int = 0):
    """Sessions that each cross from their home cell into the next one
    partway through generation — the same scripted crossing per rid no
    matter which policy replays it."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        home = i % n_cells
        cross = int(rng.integers(max(gen // 4, 2), max(gen // 2, 3)))
        cells = [home] * cross + [(home + 1) % n_cells] * (gen + 8)
        ch = MobilityChannel(cells, [cap_bps] * n_cells,
                             detach_factor=detach_factor)
        prompt = rng.integers(1, cfg.vocab_size,
                              size=prompt_len).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen,
                            channel=ch, arrival_tick=(i // n_cells) * 2))
    return reqs


def run_handover_ab(params, cfg, *, n_replicas: int, n_slots: int,
                    prompt_len: int, gen: int,
                    latency_budget_s: float = 0.006,
                    snapshot_bits: int = 0, seed: int = 0) -> dict:
    """stay vs drop vs migrate on identical mobility scripts."""
    hi, lo = _capacities(cfg, latency_budget_s)
    detach = lo / hi

    def run(policy: str, bits: int = 0) -> dict:
        cluster = EdgeCluster(
            params, cfg, n_replicas=n_replicas, n_slots=n_slots,
            cache_len=max(64, 2 * (prompt_len + gen) + 8),
            placement="best-channel", handover=policy, snapshot_bits=bits,
            latency_budget_s=latency_budget_s, max_window=4)
        reqs = make_mobility_requests(
            cfg, 2 * n_replicas * n_slots, n_cells=n_replicas,
            prompt_len=prompt_len, gen=gen, cap_bps=hi,
            detach_factor=detach, seed=seed)
        cluster.warm(reqs[0].prompt)
        t0 = time.perf_counter()
        done = cluster.run(reqs)
        wall = time.perf_counter() - t0
        st = cluster.stats()
        cluster.close()
        assert st["requests_finished"] == len(reqs), (policy, st)
        assert all(len(s.tokens) >= 1 for s in done)
        return {
            "deadline_miss_rate": round(st["deadline_miss_rate"], 4),
            "deadline_misses": st["deadline_misses"],
            "decode_wire_bytes_per_token": round(
                st["decode_wire_bytes_per_token"], 1),
            "decode_tok_per_s": round(
                st["decode_tokens"] / max(wall, 1e-9), 1),
            "handovers": st["handovers"],
            "migrations": st["migrations"],
            "migration_bytes": st["migration_bytes"],
            "replays": st["replays"],
            "replayed_tokens": st["replayed_tokens"],
            "mean_handover_latency_ticks": round(
                st["mean_handover_latency_ticks"], 2),
        }

    out = {
        "n_replicas": n_replicas,
        "n_slots": n_slots,
        "gen": gen,
        "capacity_in_cell_bps": round(hi, 1),
        "capacity_detached_bps": round(lo, 1),
        "stay": run("stay"),
        "drop": run("drop"),
        "migrate": run("migrate"),
    }
    if snapshot_bits:
        out["migrate_quantized"] = run("migrate", bits=snapshot_bits)
        out["snapshot_bits"] = snapshot_bits
        raw, q = out["migrate"], out["migrate_quantized"]
        if raw["migrations"] and q["migrations"]:
            out["snapshot_compression"] = round(
                (raw["migration_bytes"] / raw["migrations"])
                / max(q["migration_bytes"] / q["migrations"], 1e-9), 2)
    # the acceptance claim: live migration beats staying on a detached
    # link on deadline-miss rate (the reason the subsystem exists)
    out["migration_wins"] = bool(
        out["migrate"]["deadline_miss_rate"]
        < out["stay"]["deadline_miss_rate"])
    return out


def run_scaling(params, cfg, replica_counts, *, n_slots: int,
                prompt_len: int, gen: int, seed: int = 0) -> list:
    """Aggregate decode tokens/s vs replica count on a fixed offered load
    (no mobility — the router and the replicas, ticked in turn)."""
    out = []
    n_requests = 2 * max(replica_counts) * n_slots
    for n_rep in replica_counts:
        cluster = EdgeCluster(
            params, cfg, n_replicas=n_rep, n_slots=n_slots,
            cache_len=max(64, prompt_len + gen + 8),
            placement="least-loaded", handover="stay", max_window=4)
        rng = np.random.default_rng(seed)
        reqs = [Request(rid=i,
                        prompt=rng.integers(1, cfg.vocab_size,
                                            size=prompt_len).astype(np.int32),
                        max_new_tokens=gen)
                for i in range(n_requests)]
        cluster.warm(reqs[0].prompt)
        t0 = time.perf_counter()
        cluster.run(reqs)
        wall = time.perf_counter() - t0
        st = cluster.stats()
        cluster.close()
        assert st["requests_finished"] == n_requests
        out.append({
            "replicas": n_rep,
            "total_slots": n_rep * n_slots,
            "requests": n_requests,
            "decode_tok_per_s": round(
                st["decode_tokens"] / max(wall, 1e-9), 1),
            "per_replica_finished": [r["finished"]
                                     for r in st["per_replica"]],
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (default: full width)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--n-slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--ab-replicas", type=int, default=2,
                    help="replica count for the handover A/B")
    ap.add_argument("--replicas", default="1,2",
                    help="comma list of replica counts for the scaling "
                         "sweep")
    ap.add_argument("--snapshot-bits", type=int, default=8,
                    help="also run migrate with quantized snapshots at "
                         "this bit width (0 disables)")
    ap.add_argument("--latency-budget-ms", type=float, default=6.0)
    ap.add_argument("--json", "--json-out", dest="json_out", default=None,
                    metavar="PATH", help="write the full result dict as "
                    "JSON")
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import resolve_device
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = SP.init_split_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    print(f"== bench_cluster {args.arch} "
          f"({'reduced' if args.reduced else 'FULL'}) on {dev} "
          f"slots={args.n_slots} "
          f"gen={args.gen} ==", flush=True)

    ab = run_handover_ab(params, cfg, n_replicas=args.ab_replicas,
                         n_slots=args.n_slots, prompt_len=args.prompt_len,
                         gen=args.gen, snapshot_bits=args.snapshot_bits,
                         latency_budget_s=args.latency_budget_ms / 1e3)
    for pol in ("stay", "drop", "migrate"):
        r = ab[pol]
        print(f"handover,{pol},miss_rate={r['deadline_miss_rate']} "
              f"wireB/tok={r['decode_wire_bytes_per_token']} "
              f"tok/s={r['decode_tok_per_s']} "
              f"migrations={r['migrations']} replays={r['replays']} "
              f"backhaulB={r['migration_bytes']}")
    if "migrate_quantized" in ab:
        q = ab["migrate_quantized"]
        print(f"handover,migrate_q{ab['snapshot_bits']},"
              f"miss_rate={q['deadline_miss_rate']} "
              f"backhaulB={q['migration_bytes']} "
              f"compression={ab.get('snapshot_compression')}x")
    print(f"handover_summary,migration_wins="
          f"{'yes' if ab['migration_wins'] else 'no'}")

    counts = [int(s) for s in args.replicas.split(",")]
    scaling = run_scaling(params, cfg, counts, n_slots=args.n_slots,
                          prompt_len=args.prompt_len, gen=args.gen)
    for s in scaling:
        print(f"scaling,replicas={s['replicas']},"
              f"tok/s={s['decode_tok_per_s']} "
              f"finished={s['per_replica_finished']}")

    out = {"arch": args.arch, "device": str(dev),
           "reduced": bool(args.reduced), "n_slots": args.n_slots,
           "handover_ab": ab, "scaling": scaling}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
