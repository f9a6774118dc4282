"""Paper Fig. 9: information-plane trajectories of the encoder layers across
the two cascade phases (I(X;H) via GCMI, I(H;Y) via Kolchinsky KDE; mirrors
the reference package's ``benchmarks/bench_infoplane.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_infoplane \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import time
from typing import Dict, List

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


def run(n_epoch_probes: int = 5, steps_per_phase: int = 100,
        n_eval: int = 1200, device="cuda") -> Dict:
    dev = torch.device(device)
    lcfg = get_reduced("lumos5g-lstm")
    dcfg = lumos5g.Lumos5GConfig(n_samples=5_000, seq_len=lcfg.seq_len)
    data = lumos5g.generate(dcfg)
    train, test = lumos5g.train_test_split(data, dcfg)
    params = tree_map(lambda t: t.to(dev), LSTM.init_params(
        torch.Generator().manual_seed(0), lcfg))

    batches = {k: torch.from_numpy(v).to(dev) for k, v in
               lumos5g.stacked_batches(train, 128,
                                       steps_per_phase * 2).items()}
    x_np = test["x"][:n_eval]
    xe = torch.from_numpy(x_np).to(dev)
    y_tau = test["y"][:n_eval, -1]

    probe_every = max(steps_per_phase // n_epoch_probes, 1)
    acts_p1: List[Dict[str, np.ndarray]] = []
    acts_p2: List[Dict[str, np.ndarray]] = []

    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=5,
                       total_steps=steps_per_phase * 2, weight_decay=0.0)
    step_fn = C.make_train_step(
        lambda p, b, m: LSTM.loss_fn(p, b, lcfg, m), tcfg)
    state = opt.init(params)
    t0 = time.time()
    for phase in (1, 2):
        mode = phase - 1
        mask = LSTM.phase_mask(params, phase)
        for s in range(steps_per_phase):
            i = (phase - 1) * steps_per_phase + s
            batch = {k: v[i] for k, v in batches.items()}
            params, state, _ = step_fn(params, state, batch, mask, mode=mode)
            if s % probe_every == 0:
                with torch.no_grad():
                    _, acts = LSTM.forward(params, xe, lcfg, mode)
                rec = {k: v.cpu().numpy() for k, v in acts.items()
                       if k.startswith("H")}
                # the decoder sees the FINAL temporal state of H2/H3
                (acts_p1 if phase == 1 else acts_p2).append(rec)

    # information plane per probe: layer H1 truncated per paper Eq. (3),
    # H2 final state, (phase 2: H3 final state)
    def points(acts_list, names):
        out = {n: [] for n in names}
        for acts in acts_list:
            for n in names:
                h = acts[n]
                h_in = h[:, -4:, :] if n == "H1" else h[:, -1, :]
                out[n].append(info_plane.layer_point(
                    h_in, x_np, y_tau, lcfg.n_classes))
        return out

    plane1 = points(acts_p1, ["H1", "H2"])
    plane2 = points(acts_p2, ["H1", "H2", "H3"])
    return {"phase1": plane1, "phase2": plane2,
            "wall_s": time.time() - t0}


def main(argv=None) -> Dict:
    import argparse

    from repro_torch.launch.serve import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    out = run(device=resolve_device(ap.parse_args(argv).device))
    for phase, plane in (("p1", out["phase1"]), ("p2", out["phase2"])):
        for layer, pts in plane.items():
            first, last = pts[0], pts[-1]
            print(f"infoplane_{phase}_{layer},0,"
                  f"IXH {first['I_XH']:.2f}->{last['I_XH']:.2f} "
                  f"IHY {first['I_HY']:.2f}->{last['I_HY']:.2f}")
    # the paper's headline ordering: the added bottleneck layer carries less
    # information about X than the layer it compresses
    h2 = out["phase2"]["H2"][-1]
    h3 = out["phase2"]["H3"][-1]
    print(f"infoplane_dpi,0,I(X;H3) {h3['I_XH']:.2f} <= "
          f"I(X;H2) {h2['I_XH']:.2f} = {h3['I_XH'] <= h2['I_XH'] + 0.2}")
    return out


if __name__ == "__main__":
    main()
