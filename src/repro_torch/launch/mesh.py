"""Production meshes over the ranks of ``torch.distributed``, and the
H100's hardware constants the roofline divides by (the port's
counterpart of ``repro.launch.mesh``).

Functions, not module-level objects: importing this module creates no
process group and touches no CUDA state. The reference's ``mesh_context``
(entering a JAX mesh as the ambient one) has no torch counterpart: a
``TrainMesh`` / ``ServingMesh`` is passed to the code that runs on it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models import sharding

# NVIDIA H100 SXM5 constants (per GPU) used by the roofline analysis.
# Dense BF16 tensor-core peak: NVIDIA H100 datasheet, "BF16 Tensor Core
# 1,979 TFLOPS" with sparsity, halved for dense.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
# FP32 (non-tensor-core) peak: NVIDIA H100 datasheet, "FP32 67 TFLOPS".
PEAK_FLOPS_F32 = 67e12            # FLOP/s
# HBM3 bandwidth: NVIDIA H100 datasheet, "GPU memory bandwidth 3.35 TB/s".
HBM_BW = 3.35e12                  # bytes/s
# Collective bandwidth a GPU: one 400 Gb/s NDR InfiniBand adapter a GPU
# (NVIDIA DGX H100 user guide: eight ConnectX-7 400 Gb/s ports for eight
# GPUs). With 8 GPUs a node, every 16-wide axis of a production mesh
# crosses nodes, so this link bounds its collectives.
COLL_BW = 50e9                    # bytes/s
# NVLink 4 inside a node: 900 GB/s a GPU both ways (NVIDIA H100
# datasheet), 450 GB/s a direction.
NVLINK_BW = 450e9                 # bytes/s a direction


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The axes of the production mesh: one pod of ``(data 16, model
    16)`` ranks, or with ``multi_pod`` two, ``(pod 2, data 16, model
    16)``."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> sharding.TrainMesh:
    """Single pod: 16 x 16 = 256 ranks (data, model). Multi-pod: 2 pods x
    256 = 512 ranks (pod, data, model). A ``TrainMesh`` over the default
    process group, which must already hold that many ranks; call it on
    every rank. Rank r runs on ``cuda:r`` unless ``device`` is given."""
    shape = production_shape(multi_pod)
    return make_host_mesh(shape.get("pod", 1), shape["data"], shape["model"],
                          device=device)


def make_host_mesh(pod: int = 1, data: int = 2, model: int = 2, *,
                   device=None) -> sharding.TrainMesh:
    """The ``(pod?, data, model)`` mesh over the ranks of the initialized
    default process group (``pod * data * model`` of them); ``pod`` only
    where over 1. Raises ``ValueError`` where the group holds another
    number of ranks."""
    _, n = sharding.world()
    if pod * data * model != n:
        raise ValueError(f"mesh ({pod} x {data} x {model}) needs "
                         f"{pod * data * model} ranks, the group has {n}")
    return sharding.train_mesh(model, pod=pod, device=device)
