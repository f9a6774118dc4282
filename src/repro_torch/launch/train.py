"""Training launcher of the port, on one device (mirrors
``repro.launch.train`` without the mesh): random split parameters from
``--seed``, the Markov token stream (``[B, K, S]`` codebooks for audio;
for a vision arch ``--seq`` less the prefix of text after a vision prefix
drawn by ``data.tokens.make_batch``), the (optionally split) training loop
or Algorithm 1's cascade, then a checkpoint in the reference's ``.npz``
layout and its ``_history.json``.

    # on the card at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --cascade --steps 10 --batch 4 --seq 128 --ckpt-dir results/ckpt
    # the plain PyTorch path on the CPU, reduced shapes
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --reduced --device cpu --steps 4 --batch 2 --seq 32

Each step donates (the parameters and AdamW state are updated in place).
Prints ms a train step (the median after the first, the device
synchronized around each step) and, on the card, the peak device memory.
Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import cascade as CC
from repro_torch.core import split as SP
from repro_torch.data import tokens
from repro_torch.launch.serve import resolve_device
from repro_torch.training import checkpoint
from repro_torch.training import loop as L


def ms_per_step(step_times: dict) -> dict:
    """{mode: median ms of the steps after the first} (None: one step)."""
    return {m: (1e3 * statistics.median(t[1:]) if len(t) > 1 else None)
            for m, t in step_times.items()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale smoke)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", type=int, default=None,
                    help="split bottleneck mode (None = monolithic)")
    ap.add_argument("--cascade", action="store_true",
                    help="run Algorithm 1: phase-1 (mode 0) then phase-2 "
                         "(frozen backbone, train bottleneck head)")
    ap.add_argument("--mp", type=int, default=1,
                    help="model-parallel size (only 1: one device)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.mp != 1:
        raise NotImplementedError(
            "repro_torch trains on one device (--mp 1); model parallelism "
            "is ROADMAP Queue 1 item 7")
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"== repro_torch.launch.train {args.arch} "
          f"({'reduced' if args.reduced else 'FULL'}) on {dev} — "
          f"{cfg.param_count() / 1e6:.1f}M params ==", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = SP.init_split_params(gen, cfg)
    if args.resume:
        params = checkpoint.restore(args.resume, params)
        print(f"resumed from {args.resume}")

    tcfg = TrainConfig(learning_rate=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       total_steps=max(args.steps, 100), seed=args.seed)
    src = tokens.MarkovTokenSource(cfg, seed=args.seed)
    text = tokens.token_batch_shapes(cfg, args.batch, args.seq,
                                     "train")["tokens"][-1]

    def data_fn(s):
        batch = src.batch(args.batch, text, s)
        if cfg.frontend == "vision":     # the prefix: Nv + text = --seq
            batch["embeddings"] = tokens.make_batch(
                cfg, args.batch, args.seq, step=s,
                seed=args.seed)["embeddings"]
        return batch

    os.makedirs(args.ckpt_dir, exist_ok=True)
    history: dict = {}
    step_times: dict = {}
    if args.cascade:
        # Algorithm 1 over all configured modes
        def loss_fn(p, batch, mode):
            return L.make_loss_fn(cfg, mode=mode)(p, batch)

        eval_batch = L.device_batch(data_fn(10_001), dev)

        def eval_fn(p, mode):
            return L.make_eval_step(cfg, mode=mode)(p, eval_batch)

        params, hist = CC.train_cascade(
            params, loss_fn, lambda s: L.device_batch(data_fn(s), dev),
            tcfg, n_modes=cfg.split.n_modes, steps_per_phase=args.steps,
            eval_fn=eval_fn, log_every=max(args.steps // 4, 1),
            donate=True, step_times=step_times)
        history["cascade"] = hist["ensure"]
        history["phases"] = hist["phases"]
        print(f"[cascade] mode losses {hist['ensure']['losses']} "
              f"ordered={hist['ensure']['ordered']}")
    else:
        params, h = L.train_loop(params, cfg, tcfg, data_fn,
                                 steps=args.steps, mode=args.mode,
                                 log_every=10, step_times=step_times)
        history["phase1"] = h

    history["ms_per_step"] = {f"phase{i + 1}": ms for i, ms in
                              enumerate(ms_per_step(step_times).values())}
    if dev.type == "cuda":
        history["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(f"[launch.train] ms a step {history['ms_per_step']}"
          + (f", peak device memory "
             f"{history['peak_memory_bytes'] / 2**30:.2f} GiB"
             if dev.type == "cuda" else ""), flush=True)

    ck = os.path.join(args.ckpt_dir, f"{args.arch.replace('.', '_')}.npz")
    checkpoint.save(ck, params, {"arch": args.arch, "steps": args.steps,
                                 "reduced": args.reduced})
    with open(ck.replace(".npz", "_history.json"), "w") as f:
        json.dump(history, f, indent=1)
    print(f"checkpoint -> {ck}")
    return history


if __name__ == "__main__":
    main()
