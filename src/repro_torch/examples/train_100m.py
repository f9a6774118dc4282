"""End-to-end driver: train the full xlstm-125m config (~110M params) on
the synthetic Markov LM stream, monolithic or through one split mode
(mirrors the reference package's ``examples/train_100m.py``): the training
path at real, if small, scale.

    PYTHONPATH=src python -m repro_torch.examples.train_100m \\
        [--steps 300] [--seq 256] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises. Prints ms a train step (the median after the first, the device
synchronized around each step) beside the reference's tok/s line.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import split as SP
from repro_torch.data import tokens
from repro_torch.launch.serve import resolve_device
from repro_torch.launch.train import ms_per_step
from repro_torch.training import checkpoint
from repro_torch.training import loop as L
from repro_torch.training import optimizer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--mode", type=int, default=None,
                    help="split mode (None = monolithic)")
    ap.add_argument("--save", default="results/xlstm125m_torch.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("xlstm-125m")
    print(f"== xlstm-125m: {cfg.param_count() / 1e6:.0f}M params, "
          f"{cfg.n_layers}L (mLSTM/sLSTM 1:1), seq {args.seq}, {dev} ==")
    params = SP.init_split_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg)
    n = sum(x.numel() for x in optimizer.leaves(params))
    print(f"materialized {n / 1e6:.1f}M params")

    src = tokens.MarkovTokenSource(cfg, alphabet=256)
    tcfg = TrainConfig(learning_rate=6e-4, warmup_steps=20,
                       total_steps=max(args.steps, 100))
    step_times: dict = {}
    t0 = time.time()
    params, hist = L.train_loop(
        params, cfg, tcfg, lambda s: src.batch(args.batch, args.seq, s),
        steps=args.steps, mode=args.mode, log_every=5, step_times=step_times)
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    ms = ms_per_step(step_times)[args.mode]
    print(f"\n{toks} tokens in {dt:.0f}s = {toks / dt:.0f} tok/s "
          f"({6 * n * toks / dt / 1e9:.1f} GFLOP/s); "
          f"{ms if ms is None else round(ms, 2)} ms a step")
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    if args.save:
        checkpoint.save(args.save, params, {"steps": args.steps})
        print(f"checkpoint -> {args.save}")
    return {"history": hist, "ms_per_step": ms, "tokens": toks,
            "wall_s": dt, "device": str(dev)}


if __name__ == "__main__":
    main()
