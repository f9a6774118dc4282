"""Continuous-batching split serving with per-user dynamic mode selection
(Fig. 3/5 at serving scale; the port's counterpart of the reference
package's ``examples/split_serving.py``): requests from users with
*different* mmWave links stream into a slot-pooled engine; every decode
tick each in-flight request's orchestrator link state picks that user's
bottleneck mode, so one decode step routes cell-edge users through the
compressed code z' while beam-center users keep the raw code z.

    PYTHONPATH=src python -m repro_torch.examples.split_serving \\
        [--arch qwen2.5-3b] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises. A request never stops early (no EOS), so each request's modes,
wire bytes and transfer time, and the mixed-mode tick count, follow from
the seeded channels and the schedule alone, not from the weights.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.core import bottleneck as BN
from repro_torch.core import split as SP
from repro_torch.core.channel import ChannelConfig, channel_fleet
from repro_torch.core.orchestrator import (AppRequirement, ModeProfile,
                                           Orchestrator)
from repro_torch.launch.serve import resolve_device
from repro_torch.serving import ContinuousBatchingEngine, Request


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    params = SP.init_split_params(
        torch.Generator(device=dev).manual_seed(0), cfg)

    pay = {m: BN.mode_payload_bytes(cfg, 1, 1, m)
           for m in range(cfg.split.n_modes)}
    print(f"== continuous split serving {args.arch}: per-token payload "
          + " ".join(f"mode{m}={b}B" for m, b in pay.items()) + " ==")

    profiles = [ModeProfile(m, pay[m], float(m)) for m in pay]
    orch = Orchestrator(profiles, AppRequirement(latency_budget_s=0.006),
                        ema=0.5, hysteresis=1.0)
    # a fleet of user links: log-spread means put some users at the cell
    # edge (z' territory) and some at beam center (raw z is affordable)
    chans = channel_fleet(
        args.requests,
        ChannelConfig(mean_mbps=8.0, std_mbps=3.0, blockage_prob=0.08,
                      recovery_prob=0.15),
        seed=11, mean_spread=0.95)

    rng = np.random.default_rng(0)
    if cfg.frontend == "audio" and cfg.n_codebooks > 1:
        prompts = [rng.integers(1, cfg.vocab_size,
                                size=(cfg.n_codebooks, 4)).astype(np.int32)
                   for _ in range(args.requests)]
    else:
        prompts = [rng.integers(1, cfg.vocab_size, size=4).astype(np.int32)
                   for _ in range(args.requests)]
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=args.gen,
                    channel=chans[i], arrival_tick=2 * i)
            for i in range(args.requests)]

    eng = ContinuousBatchingEngine(params, cfg, n_slots=args.n_slots,
                                   cache_len=max(64, args.gen + 16),
                                   orchestrator=orch)
    done = eng.run(reqs)
    st = eng.stats()

    rows = {}
    for s in sorted(done, key=lambda s: s.request.rid):
        mbps = s.request.channel.cfg.mean_mbps
        print(f"  req {s.request.rid:2d} uplink~{mbps:5.1f}Mbps "
              f"modes={s.mode_counts} wire={s.wire_bytes}B "
              f"xfer={1e3 * s.transfer_s:.1f}ms")
        rows[s.request.rid] = {"mode_counts": dict(s.mode_counts),
                               "wire_bytes": s.wire_bytes,
                               "transfer_s": s.transfer_s,
                               "tokens": [int(t) for t in s.tokens]}
    dec_wire = sum(pay[m] * c for m, c in st["mode_counts"].items())
    raw = pay[0] * st["decode_tokens"]
    print(f"decode ticks with >=2 modes in the same batch: "
          f"{st['mixed_mode_ticks']}/{st['decode_ticks']}")
    print(f"decode wire bytes/token {dec_wire / max(st['decode_tokens'], 1):.1f} "
          f"(always-z would be {pay[0]}); saved "
          f"{100 * (1 - dec_wire / raw):.0f}% uplink")
    return {"requests": rows, "mixed_mode_ticks": st["mixed_mode_ticks"],
            "decode_ticks": st["decode_ticks"],
            "decode_tokens": st["decode_tokens"],
            "mode_counts": dict(st["mode_counts"]), "device": str(dev)}


if __name__ == "__main__":
    main()
