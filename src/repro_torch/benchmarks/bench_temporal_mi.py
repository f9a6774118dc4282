"""Paper Figs. 7-8 + Sec. VI conditional-MI numbers: temporal information
curves I(H_t; y_tau) and I(x_1..t; H_1..t) over training, and the
conditional-MI redundancy ladder that justifies truncating H^(1) to its last
few temporal states (Eq. 3; mirrors the reference package's
``benchmarks/bench_temporal_mi.py``). The headline finding: compression
occurs across the TEMPORAL dimension, not just across epochs.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_temporal_mi \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import cascade as C
from repro_torch.core.ib import info_plane
from repro_torch.data import lumos5g
from repro_torch.models import lstm as LSTM
from repro_torch.models.transformer import tree_map
from repro_torch.training import optimizer as opt


def run(n_probes: int = 4, steps: int = 120, n_eval: int = 1000,
        device="cuda") -> Dict:
    dev = torch.device(device)
    lcfg = get_reduced("lumos5g-lstm")
    dcfg = lumos5g.Lumos5GConfig(n_samples=5_000, seq_len=lcfg.seq_len)
    data = lumos5g.generate(dcfg)
    train, test = lumos5g.train_test_split(data, dcfg)
    params = tree_map(lambda t: t.to(dev), LSTM.init_params(
        torch.Generator().manual_seed(0), lcfg))
    batches = {k: torch.from_numpy(v).to(dev) for k, v in
               lumos5g.stacked_batches(train, 128, steps).items()}

    x_np = test["x"][:n_eval]
    xe = torch.from_numpy(x_np).to(dev)
    tau = lcfg.seq_len // 2             # probe label timestep (paper tau=5)
    y_tau = test["y"][:n_eval, tau]

    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=5, total_steps=steps,
                       weight_decay=0.0)
    step_fn = C.make_train_step(
        lambda p, b, m: LSTM.loss_fn(p, b, lcfg, m), tcfg)
    state = opt.init(params)
    mask = LSTM.phase_mask(params, 1)

    h1_by_epoch = []
    probe_every = max(steps // n_probes, 1)
    t0 = time.time()
    for s in range(steps):
        batch = {k: v[s] for k, v in batches.items()}
        params, state, _ = step_fn(params, state, batch, mask, mode=0)
        if s % probe_every == 0 or s == steps - 1:
            with torch.no_grad():
                _, acts = LSTM.forward(params, xe, lcfg, 0)
            h1_by_epoch.append(acts["H1"].cpu().numpy())

    curves = info_plane.temporal_curves(h1_by_epoch, x_np, y_tau,
                                        lcfg.n_classes)
    ladder = info_plane.temporal_redundancy(h1_by_epoch[-1], x_np,
                                            max_condition=3)
    return {"I_HtY": curves["I_HtY"], "I_XH": curves["I_XH"],
            "cond_mi_ladder": ladder, "wall_s": time.time() - t0}


def main(argv=None) -> Dict:
    import argparse

    from repro_torch.launch.serve import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    out = run(device=resolve_device(ap.parse_args(argv).device))
    i_hty, i_xh = out["I_HtY"], out["I_XH"]
    T = i_hty.shape[1]
    # Fig. 7 claim: I(H_t; y_tau) increases monotonically-ish with t
    print(f"temporal_IHtY,0,first {i_hty[-1,0]:.2f} mid "
          f"{i_hty[-1,T//2]:.2f} last {i_hty[-1,-1]:.2f} "
          f"increasing={bool(i_hty[-1,-1] >= i_hty[-1,0])}")
    # Fig. 8 claim: temporal compression — late-timestep I(X;H) per added
    # state flattens (redundancy across hidden temporal states)
    gaps = np.diff(i_xh[-1])
    print(f"temporal_IXH,0,early_gap {gaps[0]:.2f} late_gap {gaps[-1]:.2f} "
          f"temporal_compression={bool(gaps[-1] < gaps[0])}")
    # Sec. VI ladder: conditional MI decreases as we condition on more states
    lad = out["cond_mi_ladder"]
    print(f"temporal_condMI,0,{lad[0]:.2f} {lad[1]:.2f} {lad[2]:.2f} "
          f"decreasing={bool(lad[0] >= lad[1] >= lad[2] - 0.05)}")
    return out


if __name__ == "__main__":
    main()
