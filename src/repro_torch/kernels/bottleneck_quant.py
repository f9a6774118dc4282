"""The encoder-side wire op: the hand-written CUDA kernel of
``csrc/bottleneck_quant.cu`` (replacing the Pallas kernel of
``repro/kernels/bottleneck_quant.py``), a down-projection with a fused
row-wise symmetric quantization, one cluster launch a call. Its plain
PyTorch version is ``ref.bottleneck_quant_ref``, which
``ops.bottleneck_quant_op`` takes for CPU tensors; this wrapper takes CUDA
tensors only, launches the kernel or raises, and never falls back.
``bottleneck_quant.launches`` counts kernel launches and
``bottleneck_quant.last_plan`` is the ``wire_plan`` of the last one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wire_plan import BQ_MAX_N, wire_plan

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None
_sms = {}
_held = {}
MAX_N = BQ_MAX_N    # a cluster keeps a row tile's N f32 sums on chip


def held_clusters(dev, bf16: bool, block_n: int, cluster: int,
                  smem: int) -> int:
    """Clusters of the kernel's launch the card ``dev`` holds at once
    (cudaOccupancyMaxActiveClusters), asked once for each launch shape."""
    key = (dev, bf16, block_n, cluster, smem)
    if key not in _held:
        query = _build.bind("bottleneck_quant",
                            "bottleneck_quant_max_clusters", [_I] * 4 + [_P])
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _build.check(query(int(bf16), block_n, cluster, smem,
                               ctypes.byref(out)), "bottleneck_quant")
        _held[key] = out.value
    return _held[key]


def n_sms(dev) -> int:
    """The SM count of the card ``dev``."""
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sms[dev]


def check_wire(what, tensors, dtypes):
    """Raise unless every tensor is a contiguous CUDA tensor, all on one
    device, each of a dtype in its entry of ``dtypes``."""
    dev = tensors[0].device
    for t, ok in zip(tensors, dtypes):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the kernel takes CUDA tensors, got "
                             f"one on {t.device} (the plain version is in "
                             f"kernels.ref)")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must share a device and be "
                             f"contiguous")
        if t.dtype not in ok:
            raise TypeError(f"{what}: got {t.dtype}, takes {ok}")


def bottleneck_quant(x, w, *, bits: int = 8):
    """x: [M, K], w: [K, N], both bfloat16 or both float32, on the card ->
    (codes int8 [M, N], scales float32 [M, 1]): ``z = f32(x) @ f32(w)``,
    ``scale = max(row absmax, 1e-8) / qmax``, codes ``clip(round(z /
    scale), -qmax, qmax)`` with ``qmax = max(2**(bits-1) - 1, 1)``.
    Any M, K >= 1; 1 <= N <= 4096; bits 1..8."""
    global _fn
    what = "bottleneck_quant"
    fl = (torch.bfloat16, torch.float32)
    check_wire(what, (x, w), (fl, fl))
    if x.dtype != w.dtype:
        raise TypeError(f"{what}: x {x.dtype} and w {w.dtype} must share "
                        f"one dtype")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be [M, K] and [K, N]")
    (M, K), N = x.shape, w.shape[1]
    if M < 1 or K < 1 or not 1 <= N <= MAX_N:
        raise ValueError(f"{what}: takes M, K >= 1 and 1 <= N <= {MAX_N}, "
                         f"got {M}, {K}, {N}")
    bf = x.dtype == torch.bfloat16
    plan = wire_plan(what, M, K, N, bf16=bf, n_sms=n_sms(x.device),
                     aligned=(x.data_ptr() % 16 == 0, w.data_ptr() % 16 == 0),
                     bits=bits, max_clusters=lambda bn, cl, smem: (
                         held_clusters(x.device, bf, bn, cl, smem)))
    qmax = max((1 << (bits - 1)) - 1, 1)
    codes = torch.empty((M, N), dtype=torch.int8, device=x.device)
    scales = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if _fn is None:
        _fn = _build.bind("bottleneck_quant", "bottleneck_quant_launch",
                          [_P] * 4 + [_I] * 9 + [ctypes.c_float]
                          + [_I] * 3 + [_P])
    code = _fn(x.data_ptr(), w.data_ptr(), codes.data_ptr(),
               scales.data_ptr(), M, K, N, int(bf), plan.block_n,
               plan.cluster, plan.col_groups, plan.col_tiles, plan.k_slice,
               float(qmax),
               int(plan.vec_a), int(plan.vec_b), plan.smem_bytes,
               _build.stream_ptr(x.device))
    _build.check(code, what)
    bottleneck_quant.launches += 1
    bottleneck_quant.last_plan = plan
    return codes, scales


bottleneck_quant.launches = 0
bottleneck_quant.last_plan = None
