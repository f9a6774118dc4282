"""Quickstart: split any assigned architecture, train it with Algorithm
1's cascade, and watch the orchestrator trade wire bytes for accuracy (the
port's counterpart of the reference package's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch stablelm-3b] [--steps 60] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import bottleneck as BN
from repro_torch.core import cascade as C
from repro_torch.core import split as SP
from repro_torch.data import tokens
from repro_torch.launch.serve import resolve_device
from repro_torch.models.transformer import lm_loss
from repro_torch.training.loop import device_batch


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    print(f"== {args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model}) ==")
    print(f"split at layer {cfg.split.split_at}; "
          f"bottleneck {cfg.split.d_bottleneck} @int{cfg.split.quant_bits}")
    for mode in range(cfg.split.n_modes):
        print(f"  mode {mode}: {BN.mode_payload_bytes(cfg, 1, 1, mode)} "
              f"bytes/token on the wire "
              f"(x{BN.compression_ratio(cfg, mode):.3f})")

    params = SP.init_split_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    src = tokens.MarkovTokenSource(cfg, alphabet=32)

    def loss_fn(params, batch, mode):
        logits, aux, _ = SP.split_forward(params, batch["tokens"], cfg,
                                          mode, train=True,
                                          embeddings=batch.get("embeddings"))
        if cfg.frontend == "vision":
            logits = logits[:, -batch["labels"].shape[-1]:]
        return lm_loss(logits, batch["labels"]) + 0.01 * aux, {}

    def data_iter(step):
        return device_batch(src.batch(8, 16, step), dev)

    def eval_fn(params, mode):
        with torch.no_grad():
            loss, _ = loss_fn(params, data_iter(10_000), mode)
        return {"loss": loss}

    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5,
                       total_steps=2 * args.steps, weight_decay=0.0)
    params, hist = C.train_cascade(
        params, loss_fn, data_iter, tcfg, n_modes=2,
        steps_per_phase=args.steps, eval_fn=eval_fn, log_every=20)

    print("\n== Algorithm 1 'Ensure' check (DPI ordering) ==")
    print(f"mode losses: {['%.3f' % l for l in hist['ensure']['losses']]} "
          f"ordered={hist['ensure']['ordered']}")
    return {"history": hist, "device": str(dev)}


if __name__ == "__main__":
    main()
