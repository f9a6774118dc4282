"""The paper's end-to-end use case (Secs. V-VI): mmWave throughput prediction
with the adaptive split LSTM-Dense encoder-decoder on the (synthetic)
Lumos5G twin (mirrors the reference package's
``examples/throughput_prediction.py``).

Runs the full Algorithm 1 cascade with the paper's architecture (2x128-cell
LSTM encoder, 32-cell bottleneck, time-distributed Dense decoder, T=20,
lr=1e-2, batch=256), then the analysis:
  - per-mode payload/accuracy table (the complexity-relevance tradeoff),
  - information-plane points for both phases (Fig. 9),
  - temporal conditional-MI redundancy ladder (Sec. VI),
and writes everything to ``--out`` as JSON.

    PYTHONPATH=src python -m repro_torch.examples.throughput_prediction \\
        [--steps-per-phase 300] [--samples 70000] [--reduced] \\
        [--device cuda|cpu] [--out results/throughput_prediction_torch.json]

Runs on the card unless ``--device cpu`` is given; without a card it
raises. The weights are drawn on the CPU from seed 0 and copied to the
device, so every device starts from the same parameters; the training
batches are drawn as the reference draws them and uploaded once.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import cascade as C
from repro_torch.core.ib import info_plane
from repro_torch.data import lumos5g
from repro_torch.launch.serve import resolve_device
from repro_torch.models import lstm as LSTM
from repro_torch.models.transformer import tree_map


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps-per-phase", type=int, default=300)
    ap.add_argument("--samples", type=int, default=20_000)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny model for a fast smoke run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default="results/throughput_prediction_torch.json",
                    help="where the JSON result is written")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    lcfg = get_reduced("lumos5g-lstm") if args.reduced \
        else get_config("lumos5g-lstm")
    print(f"== paper PoC: LSTM{list(lcfg.enc_cells)} + bottleneck "
          f"{lcfg.bottleneck_cells} on Lumos5G twin "
          f"(T={lcfg.seq_len}, {args.samples} samples, {dev}) ==")

    dcfg = lumos5g.Lumos5GConfig(n_samples=args.samples,
                                 seq_len=lcfg.seq_len)
    data = lumos5g.generate(dcfg)
    train, test = lumos5g.train_test_split(data, dcfg)
    params = LSTM.init_params(torch.Generator().manual_seed(0), lcfg)
    params = tree_map(lambda t: t.to(dev), params)

    batches = {k: torch.from_numpy(v).to(dev) for k, v in
               lumos5g.stacked_batches(train, lcfg.batch_size,
                                       2 * args.steps_per_phase).items()}
    test_b = {k: torch.from_numpy(test[k][:2048]).to(dev) for k in ("x", "y")}

    def data_iter(step):
        return {k: v[step] for k, v in batches.items()}

    def eval_fn(params, mode):
        with torch.no_grad():
            loss, m = LSTM.loss_fn(params, test_b, lcfg, mode)
        return {"loss": loss, "acc": m["acc"]}

    tcfg = TrainConfig(learning_rate=lcfg.learning_rate, warmup_steps=20,
                       total_steps=2 * args.steps_per_phase,
                       weight_decay=0.0)
    t0 = time.time()
    params, hist = C.train_cascade(
        params, lambda p, b, m: LSTM.loss_fn(p, b, lcfg, m), data_iter,
        tcfg, n_modes=2, steps_per_phase=args.steps_per_phase,
        phase_mask_fn=LSTM.phase_mask, eval_fn=eval_fn, log_every=50)

    # --- the complexity-relevance table -------------------------------------
    z_bytes = lcfg.enc_cells[-1] * 4
    zp_bytes = lcfg.bottleneck_cells + 2
    print("\nmode  code           bytes/query  val_loss  val_acc")
    for m, bytes_ in ((0, z_bytes), (1, zp_bytes)):
        e = hist["phases"][m]["eval"]
        code = "z  = H_T^(2)" if m == 0 else "z' = H_T^(3)"
        print(f"  {m}   {code:14s} {bytes_:8d}    {e['loss']:.4f}   "
              f"{e['acc']:.4f}")
    print(f"Ensure (Alg. 1): ordered={hist['ensure']['ordered']}")

    # --- IB analysis (Fig. 9 + Sec. VI) --------------------------------------
    x_np = test["x"][:1500]
    xe = torch.from_numpy(x_np).to(dev)
    y_tau = test["y"][:1500, -1]
    out_ib = {}
    acts0 = None
    for mode, layers in ((0, ["H1", "H2"]), (1, ["H1", "H2", "H3"])):
        with torch.no_grad():
            _, acts = LSTM.forward(params, xe, lcfg, mode)
        if mode == 0:
            acts0 = acts
        for n in layers:
            h = acts[n].cpu().numpy()
            h_in = h[:, -4:, :] if n == "H1" else h[:, -1, :]
            out_ib[f"mode{mode}_{n}"] = info_plane.layer_point(
                h_in, x_np, y_tau, lcfg.n_classes)
    print("\ninformation plane (bits):")
    for k, v in out_ib.items():
        print(f"  {k}: I(X;H)={v['I_XH']:.2f}  I(H;Y)={v['I_HY']:.2f}")

    ladder = info_plane.temporal_redundancy(
        acts0["H1"].cpu().numpy(), x_np, max_condition=3)
    print(f"\nconditional-MI ladder I(X;H_T|H_(T-1..T-k)), k=1..3: "
          f"{['%.2f' % v for v in ladder]}")

    result = {"history": hist, "info_plane": out_ib,
              "cond_mi_ladder": [float(v) for v in ladder],
              "wall_s": time.time() - t0, "device": str(dev)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1, default=float)
    print(f"\nwrote {args.out} ({result['wall_s']:.0f}s)")
    return result


if __name__ == "__main__":
    main()
