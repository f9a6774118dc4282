"""Roofline terms of a dry run, on the H100's peaks (the port's
counterpart of ``repro.launch.roofline``):

  compute    = FLOPs / (chips x 989 TFLOP/s, dense bf16)
  memory     = HBM bytes / (chips x 3.35 TB/s)
  collective = collective bytes / (chips x 50 GB/s, one NDR link a GPU)

(``launch/mesh.py`` names the source of each peak.)

The reference parses the collectives out of the compiled post-SPMD HLO
text and multiplies the ops inside a while loop by its trip count, since
XLA lists a loop body once. The port has no HLO: its step is eager code,
one process a rank, so a trace of one rank IS the per-device program, and
a loop lists each of its iterations because it runs each of them.
:class:`CollectiveRecorder` replaces the parse: a context manager that
sees every ``torch.distributed`` collective the rank issues (at the c10d
dispatcher, so the serving engines' direct ``dist.all_reduce`` /
``dist.broadcast`` calls as well as ``models/collectives.py``'s moves)
and sums the bytes of each one's result, keyed by the reference's five
kind names. ``collective-permute`` counts each point-to-point send and
receive (the pod pipeline's ``ppermute``). A ``broadcast`` (the serving
mesh's control vectors) has no counterpart in the reference's programs
and is kept under its own key.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import COLL_BW, HBM_BW, PEAK_FLOPS_BF16

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d dispatcher ops by the kind they count under; each op's first
#: argument holds its result tensors
_KIND_OF = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast",
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments (the
    dispatcher passes it boxed as a script object)."""
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name(
                ).endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("a c10d op without a process group")


class CollectiveRecorder(TorchDispatchMode):
    """``with CollectiveRecorder() as rec:`` lists every c10d collective
    this process issues inside the block in ``rec.events``, (kind, group
    size, result bytes) in issue order; ``rec.summary()`` sums them by
    kind."""

    def __init__(self):
        super().__init__()
        self.events: List[Tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            kind = _KIND_OF.get(func._opname)
            if kind is not None:
                self.events.append((kind, _group_size(args),
                                    _tensor_bytes(args[0])))
        return func(*args, **kwargs)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{kind: {"bytes", "count"}} for the five kinds (and
        "broadcast" where one was issued): ``parse_collectives``' shape."""
        out: Dict[str, Dict[str, float]] = {
            k: {"bytes": 0, "count": 0} for k in COLLECTIVES}
        for kind, _, nbytes in self.events:
            rec = out.setdefault(kind, {"bytes": 0, "count": 0})
            rec["bytes"] += nbytes
            rec["count"] += 1
        return out


def collective_bytes_total(summary: Dict[str, Dict[str, float]]) -> int:
    return int(sum(v["bytes"] for v in summary.values()))


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int, *, per_device: bool = True) -> Dict[str, float]:
    """All inputs are per-device program quantities when per_device=True
    (a rank's trace is the per-device program); chips scales the
    aggregate hardware. Returns seconds per term + dominant."""
    if per_device:
        # per-device work over per-chip peak == aggregate over aggregate
        compute = flops / PEAK_FLOPS_BF16
        memory = hbm_bytes / HBM_BW
        collective = coll_bytes / COLL_BW
    else:
        compute = flops / (chips * PEAK_FLOPS_BF16)
        memory = hbm_bytes / (chips * HBM_BW)
        collective = coll_bytes / (chips * COLL_BW)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    terms["dominant"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["bound_s"] = max(compute, memory, collective)
    return terms


def model_flops_per_step(n_active_params: int, tokens_per_step: int,
                         kind: str = "train") -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference forward)."""
    c = 6.0 if kind == "train" else 2.0
    return c * n_active_params * tokens_per_step


def useful_ratio(model_flops: float, flops_per_device: float,
                 chips: int) -> float:
    """MODEL_FLOPS / total step FLOPs: how much of the counted compute is
    useful (catches remat / redundancy / dispatch waste)."""
    total = flops_per_device * chips
    return model_flops / total if total else 0.0
