"""Transformer training loop (mirrors ``repro.training.loop``): the loss
builders, the train and eval steps, on one device or on a training mesh
(``models.sharding.TrainMesh``), through the two-stage pod pipeline
(``core.pipeline``) or not, and the single-device driver of the examples.

A step is eager: autograd through the forward (each layer recomputed in
the backward, ``T.run_layers``), then the AdamW update, donated as the
reference's launcher donates its params and optimizer state. Metrics are
0-d device tensors, read to the host only on a logged step.

On a mesh every rank runs one process of the step (:class:`MeshRun`): it
takes its ``batch_pspec`` slice of the global batch (over the dp axes,
``data`` alone under the pipeline, whose ``pod`` axis is its stages;
where the batch does not divide, the axis drops and the batch
replicates), runs the forward on its slices of the weights
(``sharding.shard_train_params``) with the model group's tensor-parallel
plan, each data-split weight gathered whole just before its layer (FSDP:
the reference's ZeRO-3 over ``data``), averages every whole leaf's
gradient over the dp axes (one float32 all_reduce a leaf) and the metrics
with them, divides each data-split leaf's gradient, which the gather's
backward already summed over ``data``, by the ranks it sums over once,
and updates as one device does, AdamW's moments on the rank's slices and
the clip's norm summed over the split leaves' groups. The whole leaves
stay bit-identical across the ranks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import cascade as C
from repro_torch.core import pipeline as PL
from repro_torch.core import split as SP
from repro_torch.models import collectives as CL
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.serving import telemetry
from repro_torch.training import optimizer as opt

AUX_WEIGHT = 0.01     # MoE load-balance loss weight


def _check_pipeline(mesh, use_pipeline: bool) -> None:
    if use_pipeline and (mesh is None or "pod" not in mesh.shape):
        raise ValueError("use_pipeline needs a mesh with a 'pod' axis (its "
                         "stages)")


def make_loss_fn(cfg: ModelConfig, *, mode: Optional[int] = None,
                 use_pipeline: bool = False, mesh=None,
                 n_micro: int = 4, bwd_bits: int = 0) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics).

    mode None: the full-model forward; mode m: the split forward through
    bottleneck mode m (0 = raw boundary); ``use_pipeline``: the two-stage
    pod pipeline (mode ``mode or 0``; needs a ``mesh`` with a pod axis).
    ``batch``: "tokens" and "labels", [B, S] ([B, K, S] audio) int tensors
    on the parameters' device, and for a vision arch optionally
    "embeddings" [B, Nv, d], the prefix: the logits are then cut to the
    text positions before the loss. On a ``mesh`` the parameters and the
    batch are the rank's."""
    _check_pipeline(mesh, use_pipeline)
    plan = (mesh.rank_plan(cfg, SP.param_shapes(cfg)) if mesh is not None
            else None)
    run_cfg = mesh.local_cfg(cfg) if mesh is not None else cfg

    def loss_fn(params, batch):
        emb = batch.get("embeddings")
        if use_pipeline:
            logits, aux = PL.pipeline_forward(
                params, batch["tokens"], run_cfg, mesh=mesh, n_micro=n_micro,
                mode=mode or 0, train=True, bwd_bits=bwd_bits,
                embeddings=emb, plan=plan)
        elif mode is None:
            logits, aux = T.forward(params, batch["tokens"], run_cfg,
                                    train=True, embeddings=emb, plan=plan)
        else:
            logits, aux, _ = SP.split_forward(params, batch["tokens"],
                                              run_cfg, mode, train=True,
                                              embeddings=emb, plan=plan)
        labels = batch["labels"]
        if cfg.frontend == "vision" and emb is not None:
            logits = logits[:, -labels.shape[-1]:]     # text positions only
        loss = T.lm_loss(logits, labels)
        total = loss + AUX_WEIGHT * aux
        return total, {"lm_loss": loss, "aux_loss": aux}
    return loss_fn


class MeshRun:
    """A train step's part on a ``TrainMesh``: the rank's batch slice and
    the activation-rule context (:meth:`local`), the gradients and
    metrics averaged over the batch's axes (:meth:`reduce`), and the
    clip norm's split leaves (:meth:`norm_split`). ``act_policy`` /
    ``seq_shard`` / ``moe_ep``: the reference's activation rules
    (``sharding.default_activation_rules``; the port reads ``moe_ep``)."""

    def __init__(self, cfg: ModelConfig, mesh, *, use_pipeline: bool = False,
                 seq_shard: bool = True, act_policy: Optional[str] = None,
                 moe_ep: bool = False):
        self.cfg, self.mesh, self.use_pipeline = cfg, mesh, use_pipeline
        self.rules = sharding.default_activation_rules(
            mesh, seq_shard=seq_shard, act_policy=act_policy, moe_ep=moe_ep)
        self._axes = None
        self._split = None

    def batch_axes(self, batch_size: int):
        """The mesh axes the batch splits over (None: replicated)."""
        if self.use_pipeline:
            n = self.mesh.shape.get("data", 1)
            axes = ("data",) if n > 1 and batch_size % n == 0 else None
        else:
            axes = sharding.batch_pspec(self.mesh, 2, batch_size)[0]
        return axes if axes and self.mesh.size(axes) > 1 else None

    def local(self, batch):
        """(the rank's slice of ``batch``, the context to run its loss
        in)."""
        B = batch["tokens"].shape[0]
        self._axes = self.batch_axes(B)
        rules = dict(self.rules, batch=B)
        return (self.mesh.local_batch(batch, self._axes),
                sharding.activation_rules(self.mesh, rules))

    def reduce(self, grads, loss, metrics):
        """Average the gradients (in place) and (loss, metrics) over the
        last batch's axes; returns (loss, metrics). A data-split leaf's
        gradient arrives summed over ``data`` (the reduce-scatter of its
        gather): it is summed over the batch's other axes and divided by
        the ranks of both, once."""
        gs = opt.leaves(grads)
        split = opt._split_leaves(sharding.split_axes(
            grads, self.mesh, cfg=self.cfg,
            shapes=SP.param_shapes(self.cfg), stages=self.use_pipeline))
        fsdp = [g for g, a in zip(gs, split)
                if g is not None and a and "data" in a]
        if fsdp:
            axes = tuple(self._axes or ())
            rest = self.mesh.group(tuple(a for a in axes if a != "data"))
            n = torch.full((), float(self.mesh.size(
                tuple(set(axes) | {"data"}))), dtype=torch.float32,
                device=fsdp[0].device)
            for g in fsdp:
                g.copy_(CL.all_reduce_f32(g, rest) / n)
        if self._axes is None:
            return loss, metrics
        group = self.mesh.group(self._axes)
        CL.mean_grads_([g for g, a in zip(gs, split)
                        if not (a and "data" in a)], group)
        keys = sorted(metrics)
        vals = torch.stack([loss.float()] + [metrics[k].float()
                                             for k in keys])
        n = torch.full((), float(CL.size(group)), dtype=torch.float32,
                       device=vals.device)
        vals = CL.all_reduce_f32(vals, group) / n
        return vals[0], {k: vals[i + 1] for i, k in enumerate(keys)}

    def norm_split(self, params) -> dict:
        """``apply_updates``' arguments for the clip's global norm."""
        if self._split is None:
            self._split = sharding.split_axes(
                params, self.mesh, cfg=self.cfg,
                shapes=SP.param_shapes(self.cfg), stages=self.use_pipeline)
        return {"split": self._split, "group_of": self.mesh.group}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    mode: Optional[int] = None, mesh=None,
                    use_pipeline: bool = False, n_micro: int = 4,
                    seq_shard: bool = True, act_policy: Optional[str] = None,
                    moe_ep: bool = False, bwd_bits: int = 0,
                    donate: bool = True) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics).
    Gradients as ``cascade.value_and_grad`` takes them (every leaf; None
    for a leaf outside the graph, which the optimizer counts as zeros).
    ``donate``: the parameters and state passed in are updated in place.
    ``mesh``: a ``TrainMesh`` (every rank calls the step with the global
    batch and its own parameter slices and state; see the module's
    docstring); ``use_pipeline``, ``n_micro``, ``bwd_bits``: the pod
    pipeline's; ``seq_shard``, ``act_policy``, ``moe_ep``: the
    activation rules'."""
    loss_fn = make_loss_fn(cfg, mode=mode, use_pipeline=use_pipeline,
                           mesh=mesh, n_micro=n_micro, bwd_bits=bwd_bits)
    run = (MeshRun(cfg, mesh, use_pipeline=use_pipeline, seq_shard=seq_shard,
                   act_policy=act_policy, moe_ep=moe_ep)
           if mesh is not None else None)
    step = C.make_train_step(lambda p, b, _: loss_fn(p, b), tcfg,
                             donate=donate, mesh_run=run)

    def train_step(params, opt_state, batch):
        return step(params, opt_state, batch, None, mode=mode)
    return train_step


def make_eval_step(cfg: ModelConfig, *, mode: Optional[int] = None,
                   mesh=None):
    """step(params, batch) -> metrics, without autograd; on a ``mesh``
    every rank evaluates the whole batch on its parameter slices."""
    loss_fn = make_loss_fn(cfg, mode=mode, mesh=mesh)

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
               step_times: Optional[Dict] = None, mesh=None,
               verbose: bool = True) -> Tuple[Any, list]:
    """Driver of the examples and the launcher. ``params`` are updated in
    place (the step donates). ``step_times``: a dict that gets each step's
    seconds, the device synchronized, under ``mode``. ``mesh``: a
    ``TrainMesh`` (``params`` the rank's; ``data_fn`` gives the global
    batch). ``verbose``: print the logged steps."""
    dev = opt.leaves(params)[0].device
    step_fn = C.timed(make_train_step(cfg, tcfg, mode=mode, mesh=mesh),
                      step_times, mode, dev)
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
            if verbose:
                print(f"[train] step {s:5d} loss {rec['loss']:.4f} "
                      f"lm {rec['lm_loss']:.4f} lr {rec['lr']:.2e} "
                      f"({rec['wall']:.1f}s)", flush=True)
            if callback:
                callback(params, rec)
    return params, history
