"""The RG-LRU linear recurrence: the hand-written CUDA kernel of
``csrc/rglru_scan.cu`` (replacing the Pallas kernel of
``repro/kernels/rglru_scan.py``), with its plain PyTorch version beside it.
CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. ``rglru_scan.launches`` counts kernel launches.

The kernel streams each tile of channels through a ring of shared-memory
stages and walks time in order; ``scan_plan`` picks the tiling from the
shapes and the rows' alignment, and ``rglru_scan.last_plan`` is the plan
of the last launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None
_sms = {}

TILES = (32, 16, 8)      # channels a block: rows of 128, 64 or 32 bytes
STAGE_VALUES = 1024      # T * C floats of a (and of b) in one ring slot
STAGES = 4               # ring depth (kStages in the kernel): one slot
                         # scanned, one stored, 2 filling
MAX_GRID_Y = 65535       # batch rows: the grid's y extent


class ScanPlan(NamedTuple):
    """How ``rglru_scan_kernel`` covers a [B, S, D] scan: ``tile`` channels
    of one batch row a block (a scan warp and a copy warp), ``steps`` (T)
    time steps a ring slot, a ring ``stages`` deep, ``grid`` (ceil(D /
    tile), B), ``smem_bytes`` of dynamic shared memory (the a and b slots:
    min(stages, ceil(S / T)) of each), ``vec`` floats a copy (4: 16-byte
    copies and stores, for D a multiple of 4 and 16-byte aligned rows;
    else 1)."""
    tile: int
    steps: int
    stages: int
    grid: Tuple[int, int]
    smem_bytes: int
    vec: int


def scan_plan(B: int, S: int, D: int, n_sms: int = 132,
              aligned: bool = True) -> ScanPlan:
    """The kernel's tiling for a [B, S, D] scan on a card of ``n_sms``
    SMs, whose a, b and h rows start 16-byte aligned when ``aligned``.
    The tile is the widest of ``TILES`` whose B * ceil(D / tile) blocks
    give every SM a block (the narrowest where none does). A slot holds
    ``STAGE_VALUES`` floats of a tile (T = 32, 64 or 128 steps) and a
    prompt of at most T steps is one slot with every load issued at once.
    The ring is ``STAGES`` deep; a scan of fewer stages allocates only the
    slots it uses. Raises on a shape the kernel does not take."""
    if min(B, S, D) < 1 or B > MAX_GRID_Y:
        raise ValueError(f"rglru_scan: shape [{B}, {S}, {D}] not taken "
                         f"(B in 1..{MAX_GRID_Y}, S >= 1, D >= 1)")
    tile = next((c for c in TILES if B * -(-D // c) >= n_sms), TILES[-1])
    steps = min(S, STAGE_VALUES // tile)
    slots = min(STAGES, -(-S // steps))
    return ScanPlan(tile, steps, STAGES, (-(-D // tile), B),
                    2 * slots * steps * tile * 4,
                    4 if aligned and D % 4 == 0 else 1)


def rglru_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t. a, b: [B, S, D] float32; ``h0``:
    optional [B, D] float32 initial carry (zeros when omitted). Returns h:
    [B, S, D] float32, bit for bit the plain version's."""
    global _fn
    if a.device.type != "cuda":
        return rglru_scan_ref(a, b, h0)
    what = "rglru_scan"
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"{what}: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one [B, S, D] shape")
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
    if a.device not in _sms:
        _sms[a.device] = torch.cuda.get_device_properties(
            a.device).multi_processor_count
    h = torch.empty_like(a)
    # a contiguous view may start off a 16-byte boundary
    plan = scan_plan(B, S, D, _sms[a.device],
                     all(t.data_ptr() % 16 == 0 for t in (a, b, h)))
    if _fn is None:
        _fn = _build.bind("rglru_scan", "rglru_scan_launch",
                          [_P] * 4 + [_I] * 6 + [_P])
    code = _fn(a.data_ptr(), b.data_ptr(),
               None if h0 is None else h0.data_ptr(), h.data_ptr(), B, S, D,
               plan.tile, plan.steps, plan.vec, _build.stream_ptr(a.device))
    _build.check(code, what)
    rglru_scan.launches += 1
    rglru_scan.last_plan = plan
    return h


rglru_scan.launches = 0
rglru_scan.last_plan = None
