"""Fig. 3/5 narrative as numbers: dynamic mode switching under a
time-varying mmWave channel — transmission bytes, deadline violations,
and accuracy cost for static-z, static-z', and the orchestrated dynamic
policy (the port's counterpart of the reference package's
``benchmarks/bench_modes.py``: host-only, the port's channel,
orchestrator and payload model on reduced granite-8b).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_modes
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.core import bottleneck as BN
from repro_torch.core.channel import Channel, ChannelConfig, tx_seconds
from repro_torch.core.orchestrator import (AppRequirement, ModeProfile,
                                           Orchestrator)


def run(n_queries: int = 2000, tokens_per_query: int = 256,
        budget_s: float = 0.010) -> Dict:
    cfg = get_reduced("granite-8b")
    payload = {m: BN.mode_payload_bytes(cfg, 1, tokens_per_query, m)
               for m in (0, 1)}
    # relevance calibration from the cascade bench (mode 1 slightly worse)
    acc = {0: 0.86, 1: 0.81}

    ch = Channel(ChannelConfig(mean_mbps=120, std_mbps=60,
                               blockage_prob=0.04, seed=7))
    caps = ch.trace(n_queries)

    def simulate(policy) -> Dict:
        bytes_total, violations, acc_sum = 0, 0, 0.0
        orch = Orchestrator(
            [ModeProfile(m, payload[m], 1.0 - acc[m], acc[m])
             for m in (0, 1)],
            AppRequirement(latency_budget_s=budget_s))
        modes = []
        for c in caps:
            if policy == "dynamic":
                orch.observe_capacity(c)
                m = orch.choose_mode()
            else:
                m = policy
            modes.append(m)
            bytes_total += payload[m]
            if tx_seconds(payload[m], c) > budget_s:
                violations += 1
            acc_sum += acc[m]
        return {"bytes": bytes_total, "violations": violations,
                "mean_acc": acc_sum / n_queries,
                "frac_mode1": float(np.mean(np.array(modes) == 1))}

    return {"static_z": simulate(0), "static_zp": simulate(1),
            "dynamic": simulate("dynamic"), "payload": payload}


def main(argv=None) -> Dict:
    out = run()
    p = out["payload"]
    print(f"modes_payload,0,z={p[0]}B zprime={p[1]}B "
          f"ratio={p[1]/p[0]:.3f}")
    for name in ("static_z", "static_zp", "dynamic"):
        r = out[name]
        print(f"modes_{name},0,MB={r['bytes']/1e6:.2f} "
              f"viol={r['violations']} acc={r['mean_acc']:.3f} "
              f"frac_z'={r['frac_mode1']:.2f}")
    d, z, zp = out["dynamic"], out["static_z"], out["static_zp"]
    print(f"modes_summary,0,dynamic_saves_"
          f"{100 * (1 - d['bytes']/z['bytes']):.0f}%_bytes_"
          f"cuts_viol_{z['violations']}->{d['violations']}_"
          f"acc_cost_{z['mean_acc'] - d['mean_acc']:.3f}")
    return out


if __name__ == "__main__":
    main()
