"""The decoder-side wire op: the hand-written CUDA kernel of
``csrc/dequant_matmul.cu`` (replacing the Pallas kernel of
``repro/kernels/dequant_matmul.py``), a fused dequantize and
up-projection on the tensor cores, one launch a call. Its plain PyTorch
version is ``ref.dequant_matmul_ref``, which ``ops.dequant_matmul_op``
takes for CPU tensors; this wrapper takes CUDA tensors only, launches the
kernel or raises, and never falls back. ``dequant_matmul.launches`` counts
kernel launches and ``dequant_matmul.last_plan`` is the ``wire_plan`` of
the last one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bottleneck_quant import check_wire, n_sms
from repro_torch.kernels.wire_plan import DQ_MAX_K, wire_plan

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None
MAX_N = DQ_MAX_K


def dequant_matmul(codes, scales, w, *, out_dtype=torch.bfloat16):
    """codes: int8 [M, N], scales: float32 [M, 1], w: [N, D] bfloat16 or
    float32, on the card -> ``((f32(codes) * scales) @ f32(w))`` as
    ``out_dtype`` (bfloat16 or float32), [M, D]. Any M, D >= 1;
    1 <= N <= 2048."""
    global _fn
    what = "dequant_matmul"
    fl = (torch.bfloat16, torch.float32)
    check_wire(what, (codes, scales, w),
               ((torch.int8,), (torch.float32,), fl))
    if out_dtype not in fl:
        raise TypeError(f"{what}: out_dtype {out_dtype}, takes {fl}")
    if codes.dim() != 2 or w.dim() != 2 or w.shape[0] != codes.shape[1]:
        raise ValueError(f"{what}: codes {tuple(codes.shape)} and w "
                         f"{tuple(w.shape)} must be [M, N] and [N, D]")
    (M, N), D = codes.shape, w.shape[1]
    if scales.shape != (M, 1):
        raise ValueError(f"{what}: scales {tuple(scales.shape)}, expected "
                         f"({M}, 1)")
    if M < 1 or D < 1 or not 1 <= N <= MAX_N:
        raise ValueError(f"{what}: takes M, D >= 1 and 1 <= N <= {MAX_N}, "
                         f"got {M}, {N}, {D}")
    bf = w.dtype == torch.bfloat16
    plan = wire_plan(what, M, N, D, bf16=bf, n_sms=n_sms(codes.device),
                     aligned=(codes.data_ptr() % 16 == 0,
                              w.data_ptr() % 16 == 0))
    y = torch.empty((M, D), dtype=out_dtype, device=codes.device)
    if _fn is None:
        _fn = _build.bind("dequant_matmul", "dequant_matmul_launch",
                          [_P] * 4 + [_I] * 10 + [_P])
    code = _fn(codes.data_ptr(), scales.data_ptr(), w.data_ptr(),
               y.data_ptr(), M, N, D, int(bf),
               int(out_dtype == torch.bfloat16), plan.block_m, plan.block_n,
               int(plan.vec_a), int(plan.vec_b), plan.smem_bytes,
               _build.stream_ptr(codes.device))
    _build.check(code, what)
    dequant_matmul.launches += 1
    dequant_matmul.last_plan = plan
    return y


dequant_matmul.launches = 0
dequant_matmul.last_plan = None
