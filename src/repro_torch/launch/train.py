"""Training launcher of the port (mirrors ``repro.launch.train``): random
split parameters from ``--seed``, the Markov token stream (``[B, K, S]``
codebooks for audio; for a vision arch ``--seq`` less the prefix of text
after a vision prefix drawn by ``data.tokens.make_batch``), the
(optionally split) training loop or Algorithm 1's cascade, then a
checkpoint in the reference's ``.npz`` layout and its ``_history.json``.

    # on the card at full width
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --cascade --steps 10 --batch 4 --seq 128 --ckpt-dir results/ckpt
    # the plain PyTorch path on the CPU, reduced shapes
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --reduced --device cpu --steps 4 --batch 2 --seq 32
    # a (data, model) = (1, 2) mesh: two gloo ranks started here
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduced --device cpu --mp 2 --steps 4 --batch 2 --seq 32
    # (2, 2): FSDP over data, the RG-LRU mixers split over model
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma-2b --reduced --device cpu --dp 2 --mp 2 \
        --steps 4 --batch 4 --seq 32

``--mp`` takes the reference's meaning: the mesh is (data, model) with
data = ranks / mp (``ValueError`` where mp does not divide them). The
ranks are ``torchrun``'s (its environment), or ``--dp`` x ``--mp`` ranks
started here over ``--dist-backend`` (default nccl on cuda, gloo on the
CPU), one process a rank, rank r on ``cuda:r`` unless ``--device`` names
one device for all (``--device cuda:0 --dist-backend gloo`` shares one
card). Each rank holds its slices of the weights and their AdamW state
(``sharding.shard_train_params``: the model split, and where the data
axis is over 1 the reference's FSDP over it); rank 0 prints, and writes
the checkpoint gathered from every rank's slices. ``--resume`` restores
the whole tree and shards it.

Each step donates (the parameters and AdamW state are updated in place).
Prints ms a train step (the median after the first, the device
synchronized around each step), on the card the peak device memory (a
rank's), and on a mesh the collectives a step. Runs on ``cuda`` unless
``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import cascade as CC
from repro_torch.core import split as SP
from repro_torch.data import tokens
from repro_torch.launch.serve import (rank_device, resolve_device,
                                      run_on_ranks)
from repro_torch.models import collectives as CL
from repro_torch.models import sharding
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
                    help="model-parallel size (the mesh's data axis is the "
                         "ranks over mp)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card; rank r of "
                         "a mesh on cuda:r), cuda:N or cpu")
    ap.add_argument("--dp", type=int, default=None,
                    help="ranks to start over the data axis (with --mp; "
                         "under torchrun its world sets them)")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="torch.distributed backend of the ranks (default "
                         "nccl on cuda, gloo on the CPU)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.mp < 1 or (args.dp is not None and args.dp < 1):
        raise ValueError(f"mesh axes must be >= 1, got --dp {args.dp} "
                         f"--mp {args.mp}")
    if sharding.world()[1] > 1:
        world = sharding.world()[1]
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    else:
        world = (args.dp or 1) * args.mp
    check_mesh(args, world)
    if world > 1:
        return run_on_ranks(main, args,
                            sys.argv[1:] if argv is None else argv, world,
                            lambda: train_rank(args))
    return _train(args, resolve_device(args.device), None)


def check_mesh(args, world: int) -> None:
    """Raise ``ValueError`` where --mp does not divide ``world`` ranks or
    --dp x --mp is not it."""
    if world % args.mp:
        raise ValueError(f"{world} ranks not divisible by mp={args.mp}")
    if args.dp is not None and args.dp * args.mp != world:
        raise ValueError(f"--dp {args.dp} --mp {args.mp} needs "
                         f"{args.dp * args.mp} ranks, the group has {world}")


def train_rank(args) -> dict:
    """This rank's part of a mesh run (the process group is up): the
    (data, model) mesh over the group's ranks, its device, the run."""
    rank, world = sharding.world()
    check_mesh(args, world)
    dev = rank_device(args, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:                   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = sharding.train_mesh(args.mp, device=dev)
    return _train(args, dev, mesh)


def _gather_peaks(dev, mesh) -> list:
    """Each rank's peak device memory (bytes), on every rank."""
    peak = torch.tensor([torch.cuda.max_memory_allocated(dev)],
                        dtype=torch.int64)
    if mesh is None:
        return peak.tolist()
    return CL.gather_raw(peak.to(dev if mesh.backend == "nccl" else "cpu"),
                         mesh.group(mesh.axes), 0).tolist()


def _train(args, dev, mesh):
    lead = mesh is None or mesh.rank == 0
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if lead:
        print(f"== repro_torch.launch.train {args.arch} "
              f"({'reduced' if args.reduced else 'FULL'}) on {dev}"
              + (f" mesh {mesh.shape}" if mesh is not None else "")
              + f" — {cfg.param_count() / 1e6:.1f}M params ==", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = SP.init_split_params(gen, cfg)
    if args.resume:
        params = checkpoint.restore(args.resume, params)
        if lead:
            print(f"resumed from {args.resume}")
    if mesh is not None:
        params = sharding.shard_train_params(params, mesh, cfg=cfg)

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

    if lead:
        os.makedirs(args.ckpt_dir, exist_ok=True)
    history: dict = {}
    step_times: dict = {}
    CL.reset_counts()
    if args.cascade:
        # Algorithm 1 over all configured modes
        def loss_fn(p, batch, mode):
            return L.make_loss_fn(cfg, mode=mode, mesh=mesh)(p, batch)

        eval_batch = L.device_batch(data_fn(10_001), dev)

        def eval_fn(p, mode):
            return L.make_eval_step(cfg, mode=mode, mesh=mesh)(p, eval_batch)

        params, hist = CC.train_cascade(
            params, loss_fn, lambda s: L.device_batch(data_fn(s), dev),
            tcfg, n_modes=cfg.split.n_modes, steps_per_phase=args.steps,
            eval_fn=eval_fn, log_every=max(args.steps // 4, 1),
            donate=True, step_times=step_times, verbose=lead,
            mesh_run=None if mesh is None else L.MeshRun(cfg, mesh))
        history["cascade"] = hist["ensure"]
        history["phases"] = hist["phases"]
        if lead:
            print(f"[cascade] mode losses {hist['ensure']['losses']} "
                  f"ordered={hist['ensure']['ordered']}")
    else:
        params, h = L.train_loop(params, cfg, tcfg, data_fn,
                                 steps=args.steps, mode=args.mode,
                                 log_every=10, step_times=step_times,
                                 mesh=mesh, verbose=lead)
        history["phase1"] = h

    history["ms_per_step"] = {f"phase{i + 1}": ms for i, ms in
                              enumerate(ms_per_step(step_times).values())}
    if mesh is not None:
        n_steps = sum(len(t) for t in step_times.values())
        history["mesh"] = {
            "shape": mesh.shape, "backend": mesh.backend,
            "collectives_per_step": {k: v / n_steps for k, v in
                                     CL.COUNTS["calls"].items()},
            "collective_bytes_per_step": {k: v / n_steps for k, v in
                                          CL.COUNTS["bytes"].items()},
            # this rank's parameter and AdamW bytes, and the layout
            # without FSDP (weights whole over data) beside them
            "rank_bytes": sharding.layout_bytes(
                cfg, sharding._split_sizes(mesh), SP.param_shapes(cfg)),
            "rank_bytes_unsharded_data": sharding.layout_bytes(
                cfg, (("model", mesh.model),), SP.param_shapes(cfg))}
    if dev.type == "cuda":
        peaks = _gather_peaks(dev, mesh)
        history["peak_memory_bytes"] = peaks[0]
        if mesh is not None:
            history["peak_memory_bytes_by_rank"] = peaks
    if lead:
        print(f"[launch.train] ms a step {history['ms_per_step']}"
              + (f", peak device memory "
                 f"{history['peak_memory_bytes'] / 2**30:.2f} GiB"
                 if dev.type == "cuda" else "")
              + (f", collectives a step "
                 f"{history['mesh']['collectives_per_step']}"
                 if mesh is not None else ""), flush=True)

    if mesh is not None:
        params = sharding.gather_train_params(
            params, mesh, cfg=cfg, shapes=SP.param_shapes(cfg))
    ck = os.path.join(args.ckpt_dir, f"{args.arch.replace('.', '_')}.npz")
    if lead:
        checkpoint.save(ck, params, {"arch": args.arch, "steps": args.steps,
                                     "reduced": args.reduced})
        with open(ck.replace(".npz", "_history.json"), "w") as f:
            json.dump(history, f, indent=1)
        print(f"checkpoint -> {ck}")
    return history


if __name__ == "__main__":
    main()
