"""Multi-pod dry run: show that the port's distribution is coherent at the
production meshes without the hardware (the port's counterpart of
``repro.launch.dryrun``).

For an (architecture x input shape x mesh x variant) this runs the port's
own step once, as one rank of a ``torch.distributed`` world of 256
(16 x 16) or 512 (2 x 16 x 16) ranks on the ``fake`` backend, with every
tensor on the ``meta`` device (shapes and dtypes, no storage, no
arithmetic): the rank's parameter slices and AdamW moments at the shapes
the port's layout gives them (``models.sharding.rank_specs``), its batch
slice and decode state, and

- train: ``training.loop.make_train_step`` on the production
  ``TrainMesh`` (``mesh=``, ``use_pipeline=``, ``moe_ep=``,
  ``bwd_bits=``: variants ``pipeline0``-``2``);
- prefill: ``T.forward`` on the rank's batch and weight slices, or the
  pod pipeline (``core.pipeline``) or the quantized tensor-parallel
  prefill (``core.qtp``: variants ``qtp0`` / ``qtp8``);
- decode: ONE decode step (``T.decode_step``) on the serving mesh
  (``ServingMesh``: dp = pod x data, mp = model) against a state of
  ``seq_len``: the rank's dp share of the rows, its mp share of the
  weights and the state.

It records, in ``results/dryrun_torch/<tag>.json`` (the reference's keys
and file tags, so the readers of both packages take either output):

- the analytic FLOPs and HBM bytes (``launch/analytic.py``) and the
  roofline terms on the H100's peaks (``launch/roofline.py``);
- the collectives the rank issued, recorded at the c10d dispatcher
  (``roofline.CollectiveRecorder``) in place of the reference's parse of
  the compiled HLO: one rank's eager trace is its per-device program;
- ``memory_analysis.argument_size_in_bytes``: the bytes of the rank's
  parameter slices, moments, batch slice and decode state, exact. The
  reference's ``temp_size_in_bytes`` (XLA's buffer assignment) has no
  counterpart on the meta device and is left out (``temp_note``);
- the coherence check: the step runs as rank 0 and as the last rank,
  whose coordinates differ on every axis, and their ordered lists of
  (kind, group size, bytes) must be equal (the port's rule that every rank
  issues the same collectives in the same order); ``ranks_checked``;
- ``differences``: where the port's program departs from the reference's
  (``ROADMAP.md``, "Differences, not faults").

A combination the port cannot take raises with its reason; ``main``
reports it as a failure, as the reference's does. Nothing happens at
import: the fake process group is created and destroyed around each
rank's run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k [--multipod | --both-meshes] [--variant ...]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import types
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import split as SP
from repro_torch.data.tokens import token_batch_shapes
from repro_torch.launch import analytic, roofline
from repro_torch.launch.mesh import make_host_mesh, production_shape
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.models.moe_ep import moe_supports_ep
from repro_torch.training import loop as train_loop
from repro_torch.training import optimizer as opt

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# full-attention archs skip long_500k (sub-quadratic required)
LONG_CTX_ARCHS = ("mixtral-8x7b", "recurrentgemma-2b", "xlstm-125m")

VARIANTS = ("baseline", "pipeline0", "pipeline1", "pipeline2", "qtp0",
            "qtp8")

META = torch.device("meta")
N_MICRO = 4          # the pipeline's microbatches, as the reference's


def pair_supported(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CTX_ARCHS
    return True


# ---------------------------------------------------------------------------
# the fake world, and the recorder that runs the step
# ---------------------------------------------------------------------------

_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _key(x):
    """A hashable description of an op argument (a meta tensor by its
    shape, strides, dtype and offset); TypeError for anything else."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError("not a meta tensor")
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    if isinstance(x, _PLAIN):
        return x
    raise TypeError(type(x))


def _spec(out):
    if isinstance(out, torch.Tensor):
        if out.storage_offset() != 0:
            raise TypeError("offset output")
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_spec(v) for v in out))
    raise TypeError(type(out))


def _build(spec):
    if isinstance(spec[0], tuple):
        return torch.empty_strided(spec[0], spec[1], dtype=spec[2],
                                   device=META)
    return spec[0](_build(s) for s in spec[1])


class MetaRun(roofline.CollectiveRecorder):
    """The collective recorder, which also remembers the output shapes of
    each functional op on meta tensors by its inputs' shapes (a loop over
    blocks or time repeats the same few): a repeated op gets fresh meta
    outputs of the remembered shapes without its shape function running
    again. View, in-place and collective ops always run."""

    def __init__(self):
        super().__init__()
        self._memo: Dict[Any, Any] = {}
        self._pure: Dict[Any, bool] = {}

    def _cacheable(self, func) -> bool:
        ok = self._pure.get(func)
        if ok is None:
            s = func._schema
            ok = (func.namespace != "c10d" and not func.is_view
                  and not s.is_mutable
                  and all(r.alias_info is None for r in s.returns))
            self._pure[func] = ok
        return ok

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._cacheable(func):
            return super().__torch_dispatch__(func, types, args, kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
            hit = self._memo.get(key)
        except TypeError:
            return func(*args, **kwargs)
        if hit is not None:
            return _build(hit)
        out = func(*args, **kwargs)
        try:
            self._memo[key] = _spec(out)
        except TypeError:
            pass
        return out


@contextlib.contextmanager
def fake_world(rank: int, world: int):
    """This process as ``rank`` of a ``fake``-backend world of ``world``
    ranks (collectives return at once, touching nothing) for the block;
    destroyed after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the rank's abstract inputs (meta tensors)
# ---------------------------------------------------------------------------

def meta_params(cfg: ModelConfig):
    """The whole split-parameter tree of ``cfg`` on the meta device."""
    return sharding._map_paths(
        lambda _, a: torch.empty(a.shape, dtype=a.dtype, device=META),
        SP.abstract_split_params(cfg))


def _leaves(args: Dict[str, Any]) -> Dict[str, tuple]:
    """{group/path: (shape, bytes)} of every tensor of the step's
    arguments."""
    out = {}
    for group, tree in args.items():
        for path, a in sharding._path_leaves(tree):
            if isinstance(a, torch.Tensor):
                out[f"{group}/{path}"] = (tuple(a.shape),
                                          a.numel() * a.element_size())
    return out


def meta_batch(cfg: ModelConfig, sc: ShapeConfig) -> Dict[str, torch.Tensor]:
    """One global batch of ``sc`` on the meta device (the reference's
    ``input_specs``)."""
    return {name: torch.empty(shape, device=META, dtype=(
        torch.float32 if name == "embeddings" else torch.int32))
        for name, shape in token_batch_shapes(cfg, sc.global_batch,
                                              sc.seq_len, sc.kind).items()}


def _check_variant(cfg: ModelConfig, sc: ShapeConfig, shape: Dict[str, int],
                   variant: str, policy: str, tp_scope: str, moe_ep: bool,
                   kv_bits: int) -> None:
    """Raise ``ValueError`` with the reason for a combination the port
    cannot take."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant.startswith("pipeline"):
        if sc.kind == "decode":
            raise ValueError("the pod pipeline runs train and prefill "
                             "shapes only")
        if "pod" not in shape:
            raise ValueError("the pod pipeline needs the 2x16x16 mesh "
                             "(--multipod)")
        if not cfg.homogeneous or cfg.n_layers % shape["pod"]:
            raise ValueError(f"{cfg.name}: the pod pipeline needs a "
                             f"homogeneous stack of a multiple of "
                             f"{shape['pod']} layers")
        data = shape["data"]
        rows = sc.global_batch // data if sc.global_batch % data == 0 \
            else sc.global_batch
        if rows % N_MICRO:
            raise ValueError(
                f"the pod pipeline splits each data rank's rows into "
                f"{N_MICRO} microbatches (the reference microbatches the "
                f"global batch): batch {sc.global_batch} over data {data} "
                f"leaves {rows} a rank")
    if variant.startswith("qtp"):
        from repro_torch.core.qtp import qtp_supported
        if sc.kind != "prefill":
            raise ValueError("the quantized tensor-parallel prefill runs "
                             "prefill shapes only")
        if not qtp_supported(cfg, types_mesh(shape), sc.seq_len):
            raise ValueError(f"{cfg.name}: qtp needs a homogeneous attention "
                             f"stack without experts whose heads, KV heads, "
                             f"d_ff and sequence divide model "
                             f"{shape['model']}")
    if policy == "batch2d":
        raise ValueError("act_policy batch2d: the port's steps split the "
                         "batch over the dp axes only (the residual "
                         "replicates over model under every policy)")
    if tp_scope == "ffn":
        on = sharding.check_model_parallel(cfg, shape["model"])
        mixers = [k for k in ("attn", "rglru", "mlstm") if on[k]]
        if mixers:
            raise ValueError(
                f"tp_scope ffn: the port's plan splits every block kind "
                f"whose sizes divide the model axis (check_model_parallel); "
                f"{cfg.name}'s {'/'.join(mixers)} mixers would split at "
                f"model {shape['model']}, and no ffn-only scope exists")
    if moe_ep:
        if not cfg.is_moe:
            raise ValueError(f"{cfg.name} has no experts (--moe-ep)")
        if sc.kind == "decode":
            raise ValueError("moe_ep runs on a training mesh (train and "
                             "prefill shapes); serving splits experts over "
                             "mp")
        if not moe_supports_ep(cfg.n_experts, types_mesh(shape),
                               sc.global_batch, sc.seq_len):
            raise ValueError(
                f"moe_ep needs E % model == 0, the batch divisible by the dp "
                f"ranks and the sequence by model: E={cfg.n_experts}, "
                f"batch {sc.global_batch}, seq {sc.seq_len}, mesh {shape}")
    if kv_bits and sc.kind != "decode":
        raise ValueError("--kv-bits applies to decode shapes")


def types_mesh(shape: Dict[str, int]):
    """An object with the mesh's ``shape`` (what the layout predicates
    read)."""
    return types.SimpleNamespace(shape=dict(shape))


# ---------------------------------------------------------------------------
# one rank's step
# ---------------------------------------------------------------------------

def _train_mesh(shape: Dict[str, int]) -> sharding.TrainMesh:
    return make_host_mesh(shape.get("pod", 1), shape["data"],
                          shape["model"], device=META)


def _train_step(cfg, sc, shape, variant, policy, moe_ep):
    mesh = _train_mesh(shape)
    use_pipe = variant.startswith("pipeline")
    mode = int(variant[-1]) if use_pipe else None
    bwd_bits = 0
    if use_pipe and mode == 2:        # pipeline2 = mode-1 + int8 bwd wire
        mode, bwd_bits = 1, 8
    step = train_loop.make_train_step(
        cfg, TrainConfig(), mode=mode, mesh=mesh, use_pipeline=use_pipe,
        n_micro=N_MICRO, act_policy=policy, moe_ep=moe_ep,
        bwd_bits=bwd_bits)
    params = sharding.shard_train_params(meta_params(cfg), mesh, cfg=cfg,
                                         stages=use_pipe)
    state = opt.init(params)
    batch = meta_batch(cfg, sc)
    run = train_loop.MeshRun(cfg, mesh, use_pipeline=use_pipe)
    local = mesh.local_batch(batch, run.batch_axes(sc.global_batch))
    args = {"params": params, "opt": state._asdict(), "batch": local}
    return (lambda: step(params, state, batch)), args, mesh


def _prefill_step(cfg, sc, shape, variant, policy, moe_ep):
    mesh = _train_mesh(shape)
    use_pipe = variant.startswith("pipeline")
    use_qtp = variant.startswith("qtp")
    mode = int(variant[-1]) if (use_pipe or use_qtp) else None
    params = sharding.shard_train_params(meta_params(cfg), mesh, cfg=cfg,
                                         stages=use_pipe)
    batch = meta_batch(cfg, sc)
    run = train_loop.MeshRun(cfg, mesh, use_pipeline=use_pipe,
                             act_policy=policy, moe_ep=moe_ep)
    plan = mesh.rank_plan(cfg, SP.param_shapes(cfg))
    run_cfg = mesh.local_cfg(cfg)

    def prefill():
        with torch.no_grad():
            if use_qtp:
                from repro_torch.core import qtp as QTP
                return QTP.qtp_forward(params, batch["tokens"], cfg,
                                       mesh=mesh, bits=mode,
                                       embeddings=batch.get("embeddings"))
            local, ctx = run.local(batch)
            with ctx:
                if use_pipe:
                    from repro_torch.core import pipeline as PL
                    return PL.pipeline_forward(
                        params, local["tokens"], run_cfg, mesh=mesh,
                        n_micro=N_MICRO, mode=mode,
                        embeddings=local.get("embeddings"), plan=plan)[0]
                return T.forward(params, local["tokens"], run_cfg,
                                 embeddings=local.get("embeddings"),
                                 plan=plan)[0]

    local = mesh.local_batch(batch, run.batch_axes(sc.global_batch))
    return prefill, {"params": params, "batch": local}, mesh


def _decode_step(cfg, sc, shape, kv_bits):
    dp = shape.get("pod", 1) * shape["data"]
    mp = shape["model"]
    mesh = sharding.serving_mesh(dp, mp, device=META)
    params = sharding.shard_params(meta_params(cfg), mesh, cfg=cfg)
    rows = sc.global_batch // dp if sc.global_batch % dp == 0 \
        else sc.global_batch
    states = T.init_decode_state(cfg, rows, sc.seq_len, device=META,
                                 kv_bits=kv_bits, mp=mp)
    tok_shape = token_batch_shapes(cfg, rows, sc.seq_len, "decode")["tokens"]
    token = torch.empty(tok_shape, dtype=torch.int32, device=META)
    plan = mesh.rank_plan(cfg)
    run_cfg = mesh.local_cfg(cfg)

    def decode():
        with torch.no_grad():
            return T.decode_step(params, token, states, sc.seq_len - 1,
                                 run_cfg, plan=plan)[0]

    return decode, {"params": params, "states": states,
                    "batch": {"tokens": token}}, mesh


def rank_run(cfg: ModelConfig, sc: ShapeConfig, shape: Dict[str, int],
             rank: int, *, variant: str = "baseline", policy: str = "seq",
             moe_ep: bool = False, kv_bits: int = 0) -> Dict[str, Any]:
    """Run the step once as ``rank`` of the fake world of ``shape``'s
    ranks. Returns {"events": [(kind, group size, bytes), ...],
    "summary", "leaves" (``_leaves`` of the step's arguments),
    "argument_bytes", "coords", "out_shape", "seconds"}."""
    world = math.prod(shape.values())
    t0 = time.perf_counter()
    with fake_world(rank, world):
        if sc.kind == "train":
            fn, args, mesh = _train_step(cfg, sc, shape, variant, policy,
                                         moe_ep)
        elif sc.kind == "prefill":
            fn, args, mesh = _prefill_step(cfg, sc, shape, variant, policy,
                                           moe_ep)
        else:
            fn, args, mesh = _decode_step(cfg, sc, shape, kv_bits)
        leaves = _leaves(args)
        with MetaRun() as rec:
            out = fn()
        coords = (dict(mesh.coords) if isinstance(mesh.coords, dict)
                  else {"dp": mesh.coords[0], "mp": mesh.coords[1]})
    if isinstance(out, tuple):                         # a train step
        out = out[2]["loss"]
    return {"events": rec.events, "summary": rec.summary(),
            "leaves": leaves,
            "argument_bytes": sum(n for _, n in leaves.values()),
            "coords": coords,
            "out_shape": list(out.shape),
            "seconds": time.perf_counter() - t0}


def differences(cfg: ModelConfig, sc: ShapeConfig, shape: Dict[str, int],
                policy: str, variant: str) -> List[str]:
    """Where this run's program departs from the reference's (ROADMAP.md,
    "Differences, not faults")."""
    out = []
    m = shape["model"]
    on = sharding.check_model_parallel(cfg, m)
    whole = sorted(k for k, v in on.items() if not v
                   and k in {cfg.block_kind(i) for i in range(cfg.n_layers)}
                   | ({"mlp"} if cfg.d_ff else set()))
    if whole:
        out.append(f"block kinds replicated over model {m} (sizes do not "
                   f"divide; the reference's _fit_spec drops the spec "
                   f"alike): {', '.join(whole)}")
    if sc.kind == "decode":
        out.append("decode on the serving mesh: weights replicated over dp "
                   "(the reference's specs split them over data), the "
                   "embedding, final norm, LM head and bank over mp; this "
                   "step decodes the rank's dp share of the rows, where the "
                   "serving engines decode every slot's row on every dp "
                   "rank (dp splits the paged KV memory, not the decode "
                   "FLOPs)")
    else:
        out.append("the embedding, final norm, LM head and bottleneck bank "
                   "replicate over model (the reference splits the table "
                   "and the head over model)")
        if policy == "seq":
            out.append("act_policy seq: the residual replicates over model "
                       "(the reference shards the sequence over model "
                       "under GSPMD)")
        if {"mlstm", "slstm"} & set(cfg.block_pattern) and \
                on["mlstm"]:
            out.append("the sLSTM's r_* and the xLSTM gate biases split "
                       "with their heads (the reference replicates them)")
        if shape.get("data", 1) > 1:
            out.append("FSDP: each layer gathers its data-split weights "
                       "whole at each use (GSPMD schedules its own "
                       "gathers)")
    if variant.startswith("pipeline"):
        out.append("pipeline: each pod rank holds its stage's half of the "
                   "layers; the batch splits over data only")
    return out


# ---------------------------------------------------------------------------
# run one combination
# ---------------------------------------------------------------------------

def _tag(arch: str, shape: str, mesh: str, variant: str, policy: str,
         tp_scope: str, moe_ep: bool, kv_bits: int) -> str:
    tag = f"{arch}__{shape}__{mesh.replace('x', '_')}"
    if variant != "baseline":
        tag += f"__{variant}"
    if policy == "batch":
        tag += "__noseqshard"
    elif policy != "seq":
        tag += f"__{policy}"
    if tp_scope != "all":
        tag += f"__tp{tp_scope}"
    if moe_ep:
        tag += "__ep"
    if kv_bits:
        tag += f"__kv{kv_bits}"
    return tag


def run_one(arch: str, shape: str, *, multi_pod: bool = False,
            variant: str = "baseline", seq_shard: bool = True,
            act_policy: Optional[str] = None, tp_scope: str = "all",
            moe_ep: bool = False, kv_bits: int = 0,
            save: bool = True, verbose: bool = True,
            cfg: Optional[ModelConfig] = None,
            shape_cfg: Optional[ShapeConfig] = None,
            mesh_shape: Optional[Dict[str, int]] = None,
            results_dir: Optional[str] = None,
            leaves: bool = False) -> Dict[str, Any]:
    """The dry run of one combination (see the module's docstring).
    ``cfg`` / ``shape_cfg`` / ``mesh_shape`` replace the published config,
    the registry's shape and the production mesh (the tests' small runs);
    ``results_dir`` replaces ``RESULTS_DIR``; ``leaves`` adds each
    argument leaf's local shape and bytes (``argument_leaves``)."""
    cfg = cfg or get_config(arch)
    sc = shape_cfg or get_shape(shape)
    if not pair_supported(arch, shape):
        return {"arch": arch, "shape": shape, "skipped": True,
                "reason": "full-attention arch; long_500k requires "
                          "sub-quadratic decode"}
    mshape = dict(mesh_shape or production_shape(multi_pod))
    mesh_name = "x".join(str(v) for v in mshape.values())
    chips = math.prod(mshape.values())
    policy = act_policy or ("seq" if seq_shard else "batch")
    _check_variant(cfg, sc, mshape, variant, policy, tp_scope, moe_ep,
                   kv_bits)
    t0 = time.time()
    kw = dict(variant=variant, policy=policy, moe_ep=moe_ep,
              kv_bits=kv_bits)
    first = rank_run(cfg, sc, mshape, 0, **kw)
    last = rank_run(cfg, sc, mshape, chips - 1, **kw)
    if first["events"] != last["events"]:
        n = next((i for i, (a, b) in enumerate(zip(first["events"],
                                                   last["events"]))
                  if a != b), min(len(first["events"]),
                                  len(last["events"])))
        raise RuntimeError(
            f"dryrun: ranks 0 and {chips - 1} issue different collectives "
            f"({len(first['events'])} against {len(last['events'])}; first "
            f"difference at {n}: "
            f"{first['events'][n] if n < len(first['events']) else None} "
            f"against "
            f"{last['events'][n] if n < len(last['events']) else None})")
    if first["argument_bytes"] != last["argument_bytes"]:
        raise RuntimeError(f"dryrun: ranks 0 and {chips - 1} hold different "
                           f"argument bytes")
    t_run = time.time() - t0

    coll = first["summary"]
    coll_bytes = roofline.collective_bytes_total(coll)
    flops_dev = analytic.step_flops(cfg, sc) / chips
    bytes_model = analytic.step_hbm_bytes(cfg, sc, chips,
                                          model_shard=mshape["model"],
                                          kv_bits=kv_bits)
    hbm_bytes = bytes_model.total
    terms = roofline.roofline_terms(flops_dev, hbm_bytes, coll_bytes, chips)

    toks = sc.global_batch * (1 if sc.kind == "decode" else sc.seq_len)
    mf = roofline.model_flops_per_step(
        cfg.active_param_count(), toks,
        "train" if sc.kind == "train" else "inference")
    result = {
        "arch": arch, "shape": shape, "variant": variant,
        "mesh": "2x16x16" if (mesh_shape is None and multi_pod) else
        ("16x16" if mesh_shape is None else mesh_name), "chips": chips,
        "seq_shard": policy == "seq", "act_policy": policy,
        "tp_scope": tp_scope, "moe_ep": moe_ep, "kv_bits": kv_bits,
        "flops_per_device": flops_dev,
        "hbm_bytes_per_device": hbm_bytes,
        "hbm_bytes_breakdown": dataclasses.asdict(bytes_model),
        "collective_bytes_per_device": coll_bytes,
        "collectives": coll,
        "roofline": terms,
        "peaks": {"flops_bf16": roofline.PEAK_FLOPS_BF16,
                  "hbm_bytes_per_s": roofline.HBM_BW,
                  "collective_bytes_per_s": roofline.COLL_BW,
                  "device": "NVIDIA H100 SXM (published peaks)"},
        "model_flops": mf,
        "useful_ratio": roofline.useful_ratio(mf, flops_dev, chips),
        "memory_analysis": {"argument_size_in_bytes":
                            first["argument_bytes"]},
        "temp_note": "temp_size_in_bytes not recorded: the meta device "
                     "keeps no buffers to measure",
        "ranks_checked": [0, chips - 1],
        "rank_coords": [first["coords"], last["coords"]],
        "collective_events": len(first["events"]),
        "output_shape": first["out_shape"],
        "differences": differences(cfg, sc, mshape, policy, variant),
        "run_s": round(t_run, 1),
    }
    if leaves:
        result["argument_leaves"] = {k: [list(s), n] for k, (s, n)
                                     in first["leaves"].items()}
    if verbose:
        ma = result["memory_analysis"]
        mods = [variant] + [m for m, on in (
            (policy, policy != "seq"), (f"tp={tp_scope}", tp_scope != "all"),
            ("ep", moe_ep), (f"kv{kv_bits}", kv_bits)) if on]
        print(f"[dryrun] {arch} x {shape} x {result['mesh']} "
              f"({', '.join(mods)}): "
              f"compute {terms['compute_s']*1e3:.2f}ms "
              f"memory {terms['memory_s']*1e3:.2f}ms "
              f"collective {terms['collective_s']*1e3:.2f}ms "
              f"-> {terms['dominant']}  "
              f"useful {result['useful_ratio']:.2f}  "
              f"argbytes/dev {ma['argument_size_in_bytes']/2**30:.2f}GiB "
              f"coherent over ranks {result['ranks_checked']} "
              f"({result['collective_events']} collectives; "
              f"run {t_run:.0f}s)", flush=True)
    if save:
        out_dir = results_dir or RESULTS_DIR
        os.makedirs(out_dir, exist_ok=True)
        tag = _tag(arch, shape, result["mesh"], variant, policy, tp_scope,
                   moe_ep, kv_bits)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def _attempt(combo, kw):
    """``run_one`` of ``combo`` (arch, shape, multi_pod); None, or the
    failure's (arch, shape, multi_pod, reason)."""
    arch, shape, mp = combo
    try:
        r = run_one(arch, shape, multi_pod=mp, **kw)
        if r.get("skipped"):
            print(f"[dryrun] skip {arch} x {shape}: {r['reason']}",
                  flush=True)
        return None
    except Exception as e:  # noqa: BLE001 - report and continue
        print(f"[dryrun] FAIL {arch} x {shape} multipod={mp}: {e!r}",
              flush=True)
        return (arch, shape, mp, repr(e)[:300])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + ["all"])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--act-policy", default=None,
                    choices=["seq", "batch", "batch2d"])
    ap.add_argument("--tp-scope", default="all", choices=["all", "ffn"])
    ap.add_argument("--kv-bits", type=int, default=0, choices=[0, 8],
                    help="int8 KV cache for decode shapes")
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE (requires E %% model == 0, "
                         "the batch divisible by the dp ranks and the "
                         "sequence by model)")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--results-dir", default=None,
                    help=f"where the records go (default {RESULTS_DIR})")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations run at once, each in a process of "
                         "its own (default 1: in this process)")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    kw = dict(variant=args.variant, seq_shard=not args.no_seq_shard,
              act_policy=args.act_policy, tp_scope=args.tp_scope,
              moe_ep=args.moe_ep, kv_bits=args.kv_bits,
              save=not args.no_save, results_dir=args.results_dir)
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing
        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context(
                    "spawn")) as pool:
            outcomes = list(pool.map(_attempt, combos, [kw] * len(combos)))
    else:
        outcomes = [_attempt(c, kw) for c in combos]
    failures = [f for f in outcomes if f is not None]
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
