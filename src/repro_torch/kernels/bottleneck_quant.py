"""The encoder-side wire op: the hand-written CUDA kernel of
``csrc/bottleneck_quant.cu`` (replacing the Pallas kernel of
``repro/kernels/bottleneck_quant.py``), a down-projection with a fused
row-wise symmetric quantization. Its plain PyTorch version is
``ref.bottleneck_quant_ref``, which ``ops.bottleneck_quant_op`` takes for
CPU tensors; this wrapper takes CUDA tensors only, launches the kernel or
raises, and never falls back. ``bottleneck_quant.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None
MAX_N = 4096        # pass 2 keeps a row of N f32 sums in shared memory
_SMS = 132          # H100 SXM


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
    if not isinstance(bits, int) or not 1 <= bits <= 8:
        raise ValueError(f"{what}: bits {bits!r} outside 1..8")
    qmax = max((1 << (bits - 1)) - 1, 1)
    # K slices: enough (16-row tile, slice) blocks for two per SM, at least
    # 256 deep each, at most 16
    n_ks = max(1, min(16, K // 256, -(-2 * _SMS // -(-M // 16))))
    partial = torch.empty((n_ks, M, N), dtype=torch.float32, device=x.device)
    codes = torch.empty((M, N), dtype=torch.int8, device=x.device)
    scales = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if _fn is None:
        _fn = _build.bind("bottleneck_quant", "bottleneck_quant_launch",
                          [_P] * 5 + [_I] * 4 + [ctypes.c_float, _I, _P])
    code = _fn(x.data_ptr(), w.data_ptr(), partial.data_ptr(),
               codes.data_ptr(), scales.data_ptr(), M, K, N, n_ks,
               float(qmax), int(x.dtype == torch.bfloat16),
               _build.stream_ptr(x.device))
    _build.check(code, what)
    bottleneck_quant.launches += 1
    return codes, scales


bottleneck_quant.launches = 0
