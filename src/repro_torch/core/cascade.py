"""Algorithm 1 — cascaded training producing multiple complexity-relevance
modes from ONE encoder/decoder pair (mirrors ``repro.core.cascade``).

Phase 1 trains the base network (mode 0: raw boundary code z).
Phase m+1 freezes everything trained so far, trains only bottleneck head m
(layer A: down-proj; layer B: up-proj adapter), the paper's lines 2-6.
The "Ensure I(Y; Dec1) <= I(Y; Dec2)" line is checked empirically after the
last phase via validation loss ordering (``verify_mode_ordering``).

The trainer needs only a loss function per mode and a phase mask, so it
serves the paper's LSTM (``repro_torch.models.lstm``) and a split
transformer's parameter tree alike. A step is eager: autograd through plain
tensor ops, then the masked AdamW; metrics stay on the device and are read
to the host only on a logged step.

On a training mesh (``mesh_run``, a ``training.loop.MeshRun``) each step
takes the rank's slice of the batch, runs the loss under the mesh's
activation rules, averages the gradients and metrics over the dp axes
and clips by the global norm over the split leaves. Every rank runs the
same ops in the same order in every phase, the frozen backbone's too: a
phase mask only decides which leaves the update writes, and the gradient
of every leaf is taken, so each layer's recomputation (and its
collectives) runs on every rank alike.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.transformer import tree_map
from repro_torch.training import optimizer as opt

# ---------------------------------------------------------------------------
# phase masks
# ---------------------------------------------------------------------------


def transformer_phase_mask(params, phase: int):
    """phase 1: everything except the bottleneck bank; phase m >= 2: only
    head (m-2) of the bank."""
    mask = {}
    for k, v in params.items():
        if k == "bneck_modes":
            mask[k] = tuple(tree_map(lambda _, t=(phase - 2) == i: t, head)
                            for i, head in enumerate(v))
        else:
            mask[k] = tree_map(lambda _: phase == 1, v)
    return mask


# ---------------------------------------------------------------------------
# generic cascaded trainer
# ---------------------------------------------------------------------------

def value_and_grad(loss_fn: Callable, params, batch, mode: int):
    """((loss, metrics), grads) of ``loss_fn(params, batch, mode)``, as
    ``jax.value_and_grad(..., has_aux=True)`` gives them: a gradient for
    every leaf, frozen or not (the global norm takes them all). A leaf
    outside the loss's graph gets None, which the optimizer counts as
    zeros."""
    ps = opt.leaves(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in ps]
        loss, metrics = loss_fn(opt.unflatten(params, req), batch, mode)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), opt.unflatten(params, list(grads))


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, *,
                    donate: bool = False, mesh_run=None):
    """loss_fn(params, batch, mode) -> (loss, metrics). The step returns
    (params, opt_state, metrics), its metrics 0-d device tensors; with
    ``donate`` it updates the parameters and the optimizer state passed
    in (``opt.apply_updates(donate=True)``). ``mesh_run``: the step's
    part on a training mesh (see the module's docstring)."""
    def step(params, opt_state, batch, mask, *, mode: int):
        ctx = contextlib.nullcontext()
        if mesh_run is not None:
            batch, ctx = mesh_run.local(batch)
        with ctx:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                    mode)
        norm = {}
        if mesh_run is not None:
            loss, metrics = mesh_run.reduce(grads, loss, metrics)
            norm = mesh_run.norm_split(params)
        params, opt_state, info = opt.apply_updates(
            params, grads, opt_state, tcfg, mask, donate=donate, **norm)
        metrics = dict(metrics, loss=loss, **info)
        return params, opt_state, metrics
    return step


def timed(step: Callable, step_times: Optional[Dict], key, device):
    """``step`` itself when ``step_times`` is None; else ``step`` with the
    device synchronized before and after each call, its seconds appended
    to ``step_times[key]``."""
    if step_times is None:
        return step

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(*args, **kw):
        sync()
        t0 = time.perf_counter()
        out = step(*args, **kw)
        sync()
        step_times.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    return run


def train_cascade(params,
                  loss_fn: Callable,
                  data_iter: Callable[[int], Any],
                  tcfg: TrainConfig,
                  *,
                  n_modes: int,
                  steps_per_phase: int,
                  phase_mask_fn: Callable = transformer_phase_mask,
                  eval_fn: Optional[Callable] = None,
                  log_every: int = 50,
                  verbose: bool = True,
                  donate: bool = False,
                  step_times: Optional[Dict] = None,
                  mesh_run=None) -> Tuple[Any, Dict]:
    """Run Algorithm 1 over ``n_modes`` modes (phases 1..n_modes).

    ``data_iter(step)`` yields a batch; ``loss_fn(params, batch, mode)``.
    ``eval_fn(params, mode)`` -> dict with 'loss'/'acc' for the Ensure check.
    ``donate``: every step updates the parameters in place (those passed
    in too). ``step_times``: a dict that gets each step's seconds, the
    device synchronized, under its mode. ``mesh_run``: the steps' part on
    a training mesh (``make_train_step``). Returns (params, history).
    """
    step_fn = make_train_step(loss_fn, tcfg, donate=donate,
                              mesh_run=mesh_run)
    dev = opt.leaves(params)[0].device
    opt_state = opt.init(params)
    history: Dict[str, Any] = {"phases": []}
    global_step = 0
    for phase in range(1, n_modes + 1):
        mode = phase - 1
        mask = phase_mask_fn(params, phase)
        run = timed(step_fn, step_times, mode, dev)
        phase_log: List[Dict] = []
        for s in range(steps_per_phase):
            batch = data_iter(global_step)
            params, opt_state, m = run(params, opt_state, batch, mask,
                                       mode=mode)
            global_step += 1
            if s % log_every == 0 or s == steps_per_phase - 1:
                rec = {k: float(v) for k, v in m.items()}
                rec["step"] = s
                phase_log.append(rec)
                if verbose:
                    print(f"[cascade] phase {phase} step {s:4d} "
                          f"loss {rec['loss']:.4f} acc {rec.get('acc', 0):.3f}")
        entry = {"phase": phase, "mode": mode, "log": phase_log}
        if eval_fn is not None:
            entry["eval"] = {k: float(v)
                             for k, v in eval_fn(params, mode).items()}
        history["phases"].append(entry)
    if eval_fn is not None:
        history["ensure"] = verify_mode_ordering(params, eval_fn, n_modes)
    return params, history


def verify_mode_ordering(params, eval_fn: Callable, n_modes: int) -> Dict:
    """The paper's Ensure line: each extra bottleneck mode must perform at
    most as well as the previous (relevance ordering by DPI)."""
    evals = [eval_fn(params, m) for m in range(n_modes)]
    losses = [float(e["loss"]) for e in evals]
    ordered = all(losses[i] <= losses[i + 1] + 1e-3
                  for i in range(len(losses) - 1))
    return {"losses": losses,
            "accs": [float(e.get("acc", 0.0)) for e in evals],
            "ordered": ordered}
