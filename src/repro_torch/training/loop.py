"""Transformer training loop (mirrors ``repro.training.loop`` without a mesh
or the pod pipeline): the loss builders, the train and eval steps, and the
single-device driver of the examples.

A step is eager: autograd through the forward (each layer recomputed in
the backward, ``T.run_layers``), then the AdamW update, donated as the
reference's launcher donates its params and optimizer state. Metrics are
0-d device tensors, read to the host only on a logged step.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import cascade as C
from repro_torch.core import split as SP
from repro_torch.models import transformer as T
from repro_torch.serving import telemetry
from repro_torch.training import optimizer as opt

AUX_WEIGHT = 0.01     # MoE load-balance loss weight


def _single_device(mesh, use_pipeline: bool) -> None:
    if mesh is not None or use_pipeline:
        raise NotImplementedError(
            "repro_torch trains on one device: the mesh and the pod "
            "pipeline are ROADMAP Queue 1 item 7")


def make_loss_fn(cfg: ModelConfig, *, mode: Optional[int] = None,
                 use_pipeline: bool = False, mesh=None) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics).

    mode None: the full-model forward; mode m: the split forward through
    bottleneck mode m (0 = raw boundary). ``batch``: "tokens" and "labels",
    [B, S] ([B, K, S] audio) int tensors on the parameters' device, and
    for a vision arch optionally "embeddings" [B, Nv, d], the prefix: the
    logits are then cut to the text positions before the loss."""
    _single_device(mesh, use_pipeline)

    def loss_fn(params, batch):
        emb = batch.get("embeddings")
        if mode is None:
            logits, aux = T.forward(params, batch["tokens"], cfg, train=True,
                                    embeddings=emb)
        else:
            logits, aux, _ = SP.split_forward(params, batch["tokens"], cfg,
                                              mode, train=True,
                                              embeddings=emb)
        labels = batch["labels"]
        if cfg.frontend == "vision" and emb is not None:
            logits = logits[:, -labels.shape[-1]:]     # text positions only
        loss = T.lm_loss(logits, labels)
        total = loss + AUX_WEIGHT * aux
        return total, {"lm_loss": loss, "aux_loss": aux}
    return loss_fn


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    mode: Optional[int] = None, mesh=None,
                    use_pipeline: bool = False,
                    donate: bool = True) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics).
    Gradients as ``cascade.value_and_grad`` takes them (every leaf; None
    for a leaf outside the graph, which the optimizer counts as zeros).
    ``donate``: the parameters and state passed in are updated in place."""
    loss_fn = make_loss_fn(cfg, mode=mode, use_pipeline=use_pipeline,
                           mesh=mesh)

    def step(params, opt_state, batch):
        (loss, metrics), grads = C.value_and_grad(
            lambda p, b, _: loss_fn(p, b), params, batch, mode)
        params, opt_state, info = opt.apply_updates(
            params, grads, opt_state, tcfg, donate=donate)
        return params, opt_state, dict(metrics, loss=loss, **info)
    return step


def make_eval_step(cfg: ModelConfig, *, mode: Optional[int] = None):
    """step(params, batch) -> metrics, without autograd."""
    loss_fn = make_loss_fn(cfg, mode=mode)

    def step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, batch)
        return dict(metrics, loss=loss)
    return step


def device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of host arrays (``MarkovTokenSource.batch``) as tensors on
    ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_loop(params, cfg: ModelConfig, tcfg: TrainConfig,
               data_fn: Callable[[int], Dict], *, steps: int,
               mode: Optional[int] = None, log_every: int = 20,
               callback: Optional[Callable] = None,
               step_times: Optional[Dict] = None) -> Tuple[Any, list]:
    """Single-device driver of the examples and the launcher. ``params``
    are updated in place (the step donates). ``step_times``: a dict that
    gets each step's seconds, the device synchronized, under ``mode``."""
    dev = opt.leaves(params)[0].device
    step_fn = C.timed(make_train_step(cfg, tcfg, mode=mode), step_times,
                      mode, dev)
    opt_state = opt.init(params)
    history = []
    t0 = telemetry.now()
    for s in range(steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       device_batch(data_fn(s), dev))
        if s % log_every == 0 or s == steps - 1:
            rec = {k: float(v) for k, v in m.items()}
            rec.update(step=s, wall=telemetry.now() - t0)
            history.append(rec)
            print(f"[train] step {s:5d} loss {rec['loss']:.4f} "
                  f"lm {rec['lm_loss']:.4f} lr {rec['lr']:.2e} "
                  f"({rec['wall']:.1f}s)", flush=True)
            if callback:
                callback(params, rec)
    return params, history
