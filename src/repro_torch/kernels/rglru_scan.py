"""The RG-LRU linear recurrence: the hand-written CUDA kernel of
``csrc/rglru_scan.cu`` (replacing the Pallas kernel of
``repro/kernels/rglru_scan.py``), with its plain PyTorch version beside it.
CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. ``rglru_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t. a, b: [B, S, D] float32; ``h0``:
    optional [B, D] float32 initial carry (zeros when omitted). Returns
    h: [B, S, D] float32, bit for bit the plain version's."""
    global _fn
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    what = "rglru_scan"
    if a.dim() != 3 or b.shape != a.shape or a.shape[1] < 1:
        raise ValueError(f"{what}: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one [B, S>=1, D] shape")
    B, S, D = a.shape
    ins = (a, b) if h0 is None else (a, b, h0)
    if h0 is not None and h0.shape != (B, D):
        raise ValueError(f"{what}: h0 {tuple(h0.shape)}, expected ({B}, {D})")
    for t in ins:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: takes float32, got {t.dtype}")
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must share a device and be "
                             f"contiguous")
    h = torch.empty_like(a)
    if _fn is None:
        _fn = _build.bind("rglru_scan", "rglru_scan_launch",
                          [_P] * 4 + [_I] * 3 + [_P])
    code = _fn(a.data_ptr(), b.data_ptr(),
               None if h0 is None else h0.data_ptr(), h.data_ptr(), B, S, D,
               _build.stream_ptr(a.device))
    _build.check(code, what)
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
