"""Paper 'table': complexity-relevance tradeoff of the cascaded modes
(Alg. 1 / Fig. 9 quantities) on the synthetic Lumos5G twin (mirrors the
reference package's ``benchmarks/bench_cascade.py``).

Columns: mode, payload bytes/query, val loss, val acc, I(z;X) proxy width.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_cascade \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import cascade as C
from repro_torch.data import lumos5g
from repro_torch.models import lstm as LSTM
from repro_torch.models.transformer import tree_map


def run(full: bool = False, steps_per_phase: int = 150,
        verbose: bool = False, device="cuda") -> Dict:
    dev = torch.device(device)
    lcfg = get_config("lumos5g-lstm") if full else get_reduced("lumos5g-lstm")
    dcfg = lumos5g.Lumos5GConfig(
        n_samples=70_000 if full else 6_000, seq_len=lcfg.seq_len)
    data = lumos5g.generate(dcfg)
    train, test = lumos5g.train_test_split(data, dcfg)
    params = tree_map(lambda t: t.to(dev), LSTM.init_params(
        torch.Generator().manual_seed(0), lcfg))

    batches = {k: torch.from_numpy(v).to(dev) for k, v in
               lumos5g.stacked_batches(train, lcfg.batch_size if full
                                       else 128, steps_per_phase * 2).items()}

    def data_iter(step):
        return {k: v[step % v.shape[0]] for k, v in batches.items()}

    test_b = {k: torch.from_numpy(test[k][:1024]).to(dev) for k in ("x", "y")}

    def eval_fn(params, mode):
        with torch.no_grad():
            loss, m = LSTM.loss_fn(params, test_b, lcfg, mode)
        return {"loss": loss, "acc": m["acc"]}

    tcfg = TrainConfig(
        learning_rate=lcfg.learning_rate if full else 5e-3,
        warmup_steps=10, total_steps=steps_per_phase * 2, weight_decay=0.0)
    t0 = time.time()
    params, hist = C.train_cascade(
        params, lambda p, b, m: LSTM.loss_fn(p, b, lcfg, m), data_iter,
        tcfg, n_modes=2, steps_per_phase=steps_per_phase,
        phase_mask_fn=LSTM.phase_mask, eval_fn=eval_fn, verbose=verbose)
    wall = time.time() - t0

    z_bytes = lcfg.enc_cells[-1] * 4            # z: fp32 final state
    zp_bytes = lcfg.bottleneck_cells * 1 + 2    # z': int8 + scale
    rows = []
    for mode in (0, 1):
        e = hist["phases"][mode]["eval"]
        rows.append({
            "mode": mode,
            "payload_bytes": z_bytes if mode == 0 else zp_bytes,
            "val_loss": round(e["loss"], 4),
            "val_acc": round(e["acc"], 4),
            "code_width": lcfg.enc_cells[-1] if mode == 0
            else lcfg.bottleneck_cells,
        })
    return {"rows": rows, "ensure_ordered": hist["ensure"]["ordered"],
            "wall_s": wall}


def main(argv=None) -> Dict:
    import argparse

    from repro_torch.launch.serve import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    out = run(device=resolve_device(ap.parse_args(argv).device))
    for r in out["rows"]:
        print(f"cascade_mode{r['mode']},"
              f"{out['wall_s'] * 1e6 / 300:.0f},"
              f"bytes={r['payload_bytes']} loss={r['val_loss']} "
              f"acc={r['val_acc']}")
    print(f"cascade_ensure,0,ordered={out['ensure_ordered']}")
    return out


if __name__ == "__main__":
    main()
