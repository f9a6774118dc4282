"""Expert-parallel MoE training end to end at CPU scale (the port's
counterpart of the reference package's ``examples/expert_parallel_moe.py``).

Starts 8 gloo ranks, builds the (2 data, 4 model) training mesh, and
trains the reduced phi3.5-moe config twice for the same steps and seed:
once with the MoE over model (``models/moe.py``: each rank holds its
experts and sums their gate-weighted rows with one all_reduce) and once
with the expert-parallel all-to-all schedule (``moe_ep=True``,
``models/moe_ep.py``; ``--moe-ep`` in the dry run). The losses must track
each other (the EP schedule is a placement change, not a model change),
and the EP run must issue all-to-alls (counted as the moves issued,
``collectives.COUNTS``, in place of the reference's regex over the
compiled HLO).

    PYTHONPATH=src python -m repro_torch.examples.expert_parallel_moe \\
        [--steps 8] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; without a card it
raises. On the card every rank runs on it (``cuda:rank`` modulo the cards
present; gloo, whose collectives on CUDA tensors take their all_reduce
forms).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.core import split as SP
from repro_torch.data import tokens
from repro_torch.launch.serve import resolve_device, spawn_ranks
from repro_torch.models import collectives as CL
from repro_torch.models import sharding
from repro_torch.training import loop as L
from repro_torch.training import optimizer as opt

ARCH = "phi3.5-moe-42b-a6.6b"
MESH = (2, 4)                   # (data, model)


def run(cfg, mesh, *, moe_ep: bool, steps: int, batch: int, seq: int):
    """Train ``cfg`` on this rank of ``mesh`` (a ``TrainMesh``) for
    ``steps`` steps; returns (losses, all_to_all moves issued)."""
    dev = mesh.device
    params = SP.init_split_params(
        torch.Generator(device=dev).manual_seed(0), cfg)
    params = sharding.shard_train_params(params, mesh, cfg=cfg)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                       total_steps=max(steps, 10))
    step = L.make_train_step(cfg, tcfg, mesh=mesh, act_policy="batch",
                             moe_ep=moe_ep)
    src = tokens.MarkovTokenSource(cfg, seed=3)
    opt_state = opt.init(params)
    losses = []
    CL.reset_counts()
    for s in range(steps):
        b = L.device_batch(src.batch(batch, seq, s), dev)
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
    return losses, CL.COUNTS["moves"].get("all_to_all", 0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: every rank on the card; raises "
                         "without one) or cpu")
    return ap


def compare(cfg, mesh, args, lead: bool = True) -> dict:
    """Both runs on this rank, the reference's three assertions, the
    printed lines (``lead``)."""
    ref_losses, ref_a2a = run(cfg, mesh, moe_ep=False, steps=args.steps,
                              batch=args.batch, seq=args.seq)
    ep_losses, ep_a2a = run(cfg, mesh, moe_ep=True, steps=args.steps,
                            batch=args.batch, seq=args.seq)
    gap = max(abs(a - b) for a, b in zip(ref_losses, ep_losses))
    if lead:
        print(f"MoE over model: loss {ref_losses[0]:.4f} -> "
              f"{ref_losses[-1]:.4f} (all-to-alls issued: {ref_a2a})")
        print(f"EP MoE:         loss {ep_losses[0]:.4f} -> "
              f"{ep_losses[-1]:.4f} (all-to-alls issued: {ep_a2a})")
        print(f"max per-step loss gap: {gap:.4f}")
    assert ep_a2a > 0, "EP path must issue all-to-alls"
    assert gap < 0.5, "EP and over-model training must track each other"
    assert ep_losses[-1] < ep_losses[0], "loss must decrease"
    if lead:
        print("OK — expert-parallel schedule trains identically")
    return {"ref_losses": ref_losses, "ep_losses": ep_losses,
            "ref_a2a": ref_a2a, "ep_a2a": ep_a2a, "gap": gap}


def rank_main(argv) -> dict:
    """One rank's part (the gloo group is up)."""
    args = parser().parse_args(argv)
    rank, world = sharding.world()
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:                   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    data, model = MESH
    mesh = sharding.train_mesh(model, device=dev)
    cfg = get_reduced(ARCH)
    if rank == 0:
        print(f"== reduced phi3.5-moe ({cfg.n_experts} experts, top-"
              f"{cfg.experts_per_tok}) on mesh {mesh.shape}, {dev} ==",
              flush=True)
    return compare(cfg, mesh, args, lead=rank == 0)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    resolve_device(parser().parse_args(argv).device)
    return spawn_ranks(rank_main, argv, MESH[0] * MESH[1], "gloo")


if __name__ == "__main__":
    main()
