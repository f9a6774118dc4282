#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases, each printing one JSON line; any failure exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``src/repro_torch/csrc`` compiled with ``nvcc``
   for ``sm_90a`` (one process per source, all started together);
3. capture: one prefill of each full-width model (qwen2.5-3b on the paged
   arena, recurrentgemma-2b on the dense state; random weights from
   ``--seed``), keeping what the kernel phases feed their kernels;
4. one phase per kernel, holding it against its plain PyTorch version on
   the card at the full-width shapes, with inputs taken from those
   prefills: the encoder output at the split for the boundary (both
   models' banks), the decoder output for the decode tail (qwen's LM head
   and recurrentgemma's tied embedding table), the page arena for paged
   attention, the first RG-LRU layer's gates for the scan; each phase
   times the kernel, its plain version and, where one exists, the one
   PyTorch call that computes the same function (a yardstick the port
   never calls);
5. reference: the serving entry point at reduced shapes in float32 on the
   card (kernels) and on the CPU (plain versions), for both archs, must
   decode the same tokens, modes and wire bytes;
6. main path, for each arch: ``repro_torch.launch.serve.main`` at full
   width in bf16 with the launch counters set to 0 just before and read
   just after; every request must finish, every kernel of the path must
   have launched, and the launches must match the path's prefill
   dispatches and decode ticks;
7. profile: each main path once more under ``torch.profiler``, for the
   device busy time and the kernels that take it.

Then the card's name and power limit, the ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense): HBM bytes/s and FLOP/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances against the plain versions, and why.
TOL = {
    # mode-0 rows are copied, so they must be bit-for-bit. Quantized rows
    # may differ by the GEMM rounding of two summation orders (each output
    # within 2u * sum_j |wired_j| |up_ji| + u |y_i|, u = 2^-8 in bf16 and
    # 2^-16 in f32) plus one code step at every lane whose code sits within
    # a one-ulp change of z or of the scale of a rounding edge: there the
    # two sides' sums may land on either side.
    "boundary": "mode-0 rows bit-for-bit; other rows within the GEMM "
                "rounding envelope plus one code step at rounding-edge lanes",
    # the logits are f32 sums in two orders: tokens must be equal except
    # where the plain top-two gap is below 1e-3 of the max logit, and there
    # the kernel's token must be one of the near-tied ones. An exact tie
    # must resolve to the lowest index.
    "tail_rel_gap": 1e-3,
    # the online softmax keeps the reference's rounding barriers, so bf16
    # outputs track it to an ulp or two of values of size ~1; f32 to 1e-5
    "paged_bf16_abs": 1e-2,
    "paged_f32_abs": 1e-5,
    # the scan rounds a*h and the sum separately on both sides, in the
    # same order: bit for bit
    "rglru": "bit for bit",
}


def emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int, flush=None, by_kernel=None) -> float:
    """Mean device time of one call of ``fn``: the durations of the device
    work it launches, summed over ``iters`` calls from a ``torch.profiler``
    trace, over ``iters``. Host time between launches is not counted (a
    CUDA-event bracket would count it: at these sizes the card waits on
    the Python wrapper). ``flush`` (traced but not counted) evicts the L2
    cache before each call where the caller would find the operands cold.
    ``by_kernel``: a dict that receives ms per call of each kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and FLUSH_OP not in e.name:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    us = sum(per.values())
    check(us > 0, "the profiler traced no device work")
    if by_kernel is not None:
        by_kernel.update({k[:60]: v / iters / 1e3 for k, v in per.items()})
    return us / iters / 1e3


def bound(nbytes: float, flops: float, dt: str):
    """(least time in ms, "bytes" or "operations") on the published peaks."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


FLUSH_OP = "bitwise_not"       # the flush's kernel, which nothing timed uses


def l2_flusher(dev):
    import torch
    buf = torch.zeros(128 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    return lambda: buf.bitwise_not_()


# ---------------------------------------------------------------------------
# full-width activations: one prefill through the port's model
# ---------------------------------------------------------------------------

LENS = (1000, 1, 8, 9, 100, 513, 777, 37)   # ragged, across page edges


def capture(cfg, dev, seed: int, page_len: int = 8):
    """Run one ragged prefill of the full-width model and keep what the
    kernel phases feed their kernels: the encoder output at the split, the
    decoder output before the tail, the filled page arena and the block
    table (unallocated entries point at scratch page 0)."""
    import numpy as np
    import torch

    from repro_torch.core import bottleneck
    from repro_torch.core import split as SP
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = SP.init_split_params(gen, cfg)
    stacked = bottleneck.bank_stack(params["bneck_modes"], cfg.split)
    lens = np.asarray(LENS, np.int64)
    B = len(lens)
    S = 1 << int(math.ceil(math.log2(int(lens.max()))))
    toks = torch.from_numpy(
        MarkovTokenSource(cfg, seed=7).batch(B, S)["tokens"]).to(dev)
    pages = [-(-int(n) // page_len) for n in lens]
    nb = max(pages)
    n_pages = sum(pages)
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages + 1))
    bt = np.zeros((B, nb), np.int32)
    k = 0
    for b, n in enumerate(pages):
        bt[b, :n] = perm[k:k + n]
        k += n
    arena = T.init_decode_state(cfg, n_pages + 1, page_len, device=dev)
    bt_t = torch.from_numpy(bt).to(dev)
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    modes = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1][:B], dtype=torch.int32,
                         device=dev)
    s = cfg.split.split_at
    x = T.embed_tokens(params, toks, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    enc_l, dec_l = SP.slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = SP._split_states(arena, cfg, s)
    x_enc = T.run_layers_prefill(enc_l, x, positions, enc_st, cfg,
                                 lengths=lens_t, block_table=bt_t)
    y = bottleneck.boundary_mixed(stacked, x_enc, modes,
                                  dtype=T.model_dtype(cfg))
    x_dec = T.run_layers_prefill(dec_l, y, positions, dec_st, cfg,
                                 lengths=lens_t, block_table=bt_t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    valid = torch.arange(S, device=dev)[None, :] < lens_t[:, None]
    return {"params": params, "stacked": stacked, "x_enc": x_enc,
            "x_dec": x_dec, "arena": arena, "bt": bt_t, "lens": lens,
            "valid": valid, "page_len": page_len}


@contextlib.contextmanager
def recording(module, name: str, sink: list, limit: int = 1):
    """Record (clones of) the positional arguments of the first ``limit``
    calls of ``module.name`` while the block runs."""
    import torch
    orig = getattr(module, name)

    def rec(*args):
        if len(sink) < limit:
            sink.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return orig(*args)

    setattr(module, name, rec)
    try:
        yield sink
    finally:
        setattr(module, name, orig)


RLENS = (2048, 16, 700, 1333)   # a prompt as long as the window, ragged


def capture_recurrent(cfg, dev, seed: int):
    """One ragged prefill of full-width recurrentgemma-2b on the dense
    state (rolling caches of the window's length, RG-LRU carries): the
    encoder output at the split and the decoder output before the tail,
    and the first RG-LRU layer's scan inputs at the shapes the scan phase
    checks — [4, 2048, D] (this prefill), [1, 16, D] and [4, 16, D] (the
    main path's prompts), [3, 37, D] continuing from a carried state, and
    a width that is not a multiple of 128."""
    import numpy as np
    import torch

    from repro_torch.core import bottleneck
    from repro_torch.core import split as SP
    from repro_torch.data.tokens import MarkovTokenSource
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    params = SP.init_split_params(gen, cfg)
    stacked = bottleneck.bank_stack(params["bneck_modes"], cfg.split)
    lens = np.asarray(RLENS, np.int64)
    B, S = len(lens), max(RLENS)
    toks = torch.from_numpy(
        MarkovTokenSource(cfg, seed=7).batch(B, S)["tokens"]).to(dev)
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    modes = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=dev)
    s = cfg.split.split_at
    kinds = SP._kinds(cfg)
    x = T.embed_tokens(params, toks, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    states = T.init_decode_state(cfg, B, S, device=dev)
    enc_l, dec_l = SP.slice_layers(params["layers"], cfg, s)
    enc_st, dec_st = SP._split_states(states, cfg, s)
    with recording(ops, "rglru_scan_op", []) as long_scan:
        x_enc = T.run_layers_prefill(enc_l, x, positions, enc_st, cfg,
                                     kinds=kinds[:s], lengths=lens_t)
    y = bottleneck.boundary_mixed(stacked, x_enc, modes,
                                  dtype=T.model_dtype(cfg))
    x_dec = T.run_layers_prefill(dec_l, y, positions, dec_st, cfg,
                                 kinds=kinds[s:], lengths=lens_t)
    del states, enc_st, dec_st

    def first_layer(x_in, st, nb):
        sink = []
        with recording(ops, "rglru_scan_op", sink):
            T.run_layers_prefill(params["layers"][:1], x_in,
                                 positions[:nb, :x_in.shape[1]], st, cfg,
                                 kinds=kinds[:1])
        return sink[0]

    # a fresh prompt's carry is zero: pass none (the kernel's other branch)
    scans = {"[4, 2048] prefill, no h0": long_scan[0][:2] + (None,)}
    for nb in (1, 4):
        st = T.init_decode_state(cfg, nb, 16, device=dev)[:1]
        scans[f"[{nb}, 16] main-path prefill"] = first_layer(x[:nb, :16], st,
                                                            nb)
    carry = {k: v[:3].clone() for k, v in st[0].items()}
    a, b, h0 = first_layer(x[:3, 16:53], (carry,), 3)
    scans["[3, 37] from a carried state"] = (a, b, h0)
    scans["[3, 37, 1000] odd width"] = (a[:, :, :1000].contiguous(),
                                        b[:, :, :1000].contiguous(),
                                        h0[:, :1000].contiguous())
    torch.cuda.synchronize(dev)
    valid = torch.arange(S, device=dev)[None, :] < lens_t[:, None]
    return {"params": params, "stacked": stacked, "x_enc": x_enc,
            "x_dec": x_dec, "valid": valid, "scans": scans}


def pick_rows(x, valid, n: int, seed: int):
    """``n`` real token rows of a [B, S, d] activation as [n, 1, d]."""
    import numpy as np
    import torch
    idx = torch.nonzero(valid.reshape(-1)).reshape(-1).cpu().numpy()
    sel = np.random.default_rng(seed).choice(idx, size=n, replace=False)
    return x.reshape(-1, x.shape[-1])[torch.from_numpy(np.sort(sel)).to(
        x.device)][:, None, :].contiguous()


# ---------------------------------------------------------------------------
# kernel 1: the mixed-mode boundary
# ---------------------------------------------------------------------------

# synthetic heads stacked after the model's own (width 512, 8 bits), so one
# bank covers every wire width the kernel takes
EXTRA_HEADS = ((512, 4), (384, 1), (256, 0))


def test_bank(stacked, d: int, dev, seed: int):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    wmax = stacked["down_w"].shape[2]
    dt = stacked["down_w"].dtype
    downs, ups = [stacked["down_w"]], [stacked["up_w"]]
    for w, _ in EXTRA_HEADS:
        dw = torch.randn((1, d, wmax), generator=gen, device=dev)
        uw = torch.randn((1, wmax, d), generator=gen, device=dev)
        dw, uw = dw / math.sqrt(d), uw / math.sqrt(w)
        dw[:, :, w:] = 0
        uw[:, w:, :] = 0
        downs.append(dw.to(dt))
        ups.append(uw.to(dt))
    return {
        "down_w": torch.cat(downs).contiguous(),
        "up_w": torch.cat(ups).contiguous(),
        "norm_scale": torch.cat([stacked["norm_scale"], torch.ones(
            (len(EXTRA_HEADS), d), dtype=dt, device=dev)]).contiguous(),
        "width": torch.cat([stacked["width"], torch.tensor(
            [w for w, _ in EXTRA_HEADS], dtype=torch.int32, device=dev)]),
        "bits": torch.cat([stacked["bits"], torch.tensor(
            [b for _, b in EXTRA_HEADS], dtype=torch.int32, device=dev)]),
    }


def grouped(bank, x, modes):
    """The mode-grouped layout the dispatcher builds: (xp, tables, dest,
    per-layout-row mode)."""
    import torch
    from repro_torch.kernels import ops
    B, S, d = x.shape
    block_r = 16 if x.element_size() == 2 else 8
    rmode = modes.to(torch.int32).repeat_interleave(S)
    dest, tb = ops.group_layout(bank, rmode, block_r, 128)
    xp = torch.zeros((tb["P"], d), dtype=x.dtype, device=x.device)
    xp[dest] = x.reshape(B * S, d)
    pmode = torch.zeros(tb["P"], dtype=torch.long, device=x.device)
    pmode[dest] = rmode.long()
    return xp, tb, dest, pmode, block_r


def boundary_envelope(bank, xp, pmode, used, yr):
    """Per-element bound on |kernel - plain| for the quantized rows (see
    ``TOL["boundary"]``), computed from the plain version's own z."""
    import torch
    dt = xp.dtype
    u = 2.0 ** -8 if dt == torch.bfloat16 else 2.0 ** -16
    env = torch.zeros(xp.shape, dtype=torch.float32, device=xp.device)
    for m in range(1, bank["width"].shape[0] + 1):
        rows = torch.nonzero(used & (pmode == m)).reshape(-1)
        if rows.numel() == 0:
            continue
        hid = m - 1
        width, bits = int(bank["width"][hid]), int(bank["bits"][hid])
        xf = xp[rows].float()
        h = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
        h = (h * bank["norm_scale"][hid].float()).to(dt)
        z = (h.float() @ bank["down_w"][hid].float()).to(dt).float()
        z[:, width:] = 0
        qm = float(max((1 << (max(bits, 1) - 1)) - 1, 1))
        scale = torch.clamp(z.abs().amax(-1, keepdim=True), min=1e-8) / qm
        up = bank["up_w"][hid].float().abs()
        if bits == 0:
            wired = z
            edge = torch.zeros_like(z)
        else:
            r = z / scale
            wired = torch.clamp(torch.round(r), -qm, qm) * scale
            frac = torch.abs(r.abs() - torch.floor(r.abs()) - 0.5)
            edge = (frac <= 2 * u * (r.abs() + 1)).float() * scale
        env[rows] = (2 * u * (wired.abs() @ up) + edge @ up
                     + u * yr[rows].float().abs() + 1e-6)
    return env


def check_boundary(bank, x, modes, label):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.boundary_mixed import boundary_mixed_grouped
    xp, tb, dest, pmode, block_r = grouped(bank, x, modes)
    args = (xp, bank["down_w"], bank["up_w"], bank["norm_scale"], tb["hid"],
            tb["nchunk"], tb["width"], tb["bits"])
    yk = boundary_mixed_grouped(*args, block_r=block_r, dtype=x.dtype)
    torch.cuda.synchronize()
    yr = ref.boundary_mixed_grouped_ref(*args, block_r=block_r,
                                        dtype=x.dtype)
    used = torch.zeros(xp.shape[0], dtype=torch.bool, device=x.device)
    used[dest] = True
    raw = used & (pmode == 0)
    check(torch.equal(yk[raw], yr[raw]),
          f"boundary {label}: mode-0 rows are not bit-for-bit")
    err = (yk.float() - yr.float()).abs()
    err[~used] = 0
    env = boundary_envelope(bank, xp, pmode, used, yr)
    quant = used & (pmode > 0)
    ratio = float((err[quant] / env[quant]).max()) if quant.any() else 0.0
    check(ratio <= 1.0 and bool(torch.isfinite(yk[used].float()).all()),
          f"boundary {label}: error {float(err.max())} exceeds the "
          f"envelope (worst ratio {ratio:.3f})")
    return float(err.max()), ratio


def boundary_cases(cap, label: str, d: int, dev, seed: int, gen):
    """Pool and prefill cases on one model's bank (+ the synthetic heads)
    and encoder output, in bf16 and f32."""
    import torch
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        bank = test_bank({k: (v.to(dt) if v.is_floating_point() else v)
                          for k, v in cap["stacked"].items()}, d, dev, seed)
        M = bank["width"].shape[0]
        for n in (1, 8, 32):
            x = pick_rows(cap["x_enc"], cap["valid"], n, seed + n).to(dt)
            modes = torch.randint(0, M + 1, (n,), generator=gen)
            if n >= M + 1:
                modes[:M + 1] = torch.arange(M + 1)
            cases.append((f"{label} {dtype_name(dt)} pool {n}", bank, x,
                          modes.to(dev)))
        x = cap["x_enc"][:, :64].to(dt).contiguous()     # [B, S, d] prefill
        modes = torch.arange(x.shape[0]) % (M + 1)
        cases.append((f"{label} {dtype_name(dt)} prefill {tuple(x.shape)}",
                      bank, x, modes.to(dev)))
    return cases


def time_boundary(cap, d: int, dev, seed: int, iters: int):
    """Device ms of the kernel and of its plain version at the main path's
    decode shape: 4 slots on the model's own bank, one in raw mode 0;
    with the bound of that call."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.boundary_mixed import boundary_mixed_grouped
    st = cap["stacked"]
    x4 = pick_rows(cap["x_enc"], cap["valid"], 4, seed + 4)
    modes4 = torch.tensor([1, 1, 0, 1], dtype=torch.int32, device=dev)
    xp, tb, dest, pmode, block_r = grouped(st, x4, modes4)
    args = (xp, st["down_w"], st["up_w"], st["norm_scale"], tb["hid"],
            tb["nchunk"], tb["width"], tb["bits"])
    flush = l2_flusher(dev)
    parts = {}
    ms = time_ms(lambda: boundary_mixed_grouped(*args, block_r=block_r,
                                                dtype=xp.dtype), iters, flush,
                 parts)
    plain = time_ms(lambda: ref.boundary_mixed_grouped_ref(
        *args, block_r=block_r, dtype=xp.dtype), max(iters // 5, 3), flush)
    w = int(st["width"][0])
    nq = int((modes4 > 0).sum())
    nbytes = 2 * (2 * 4 * d + 2 * d * w + d)
    b_ms, b_by = bound(nbytes, 2 * 2 * d * w * nq, "bfloat16")
    return {"timed_shape": {"rows": 4, "d": d, "width": w,
                            "modes": [1, 1, 0, 1]},
            "ms": ms, "ms_by_kernel": parts, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_boundary(cap, rcap, cfg, rcfg, dev, seed: int, iters: int):
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cases = (boundary_cases(cap, cfg.name, cfg.d_model, dev, seed, gen)
             + boundary_cases(rcap, rcfg.name, rcfg.d_model, dev, seed, gen))
    # the reduced config's widths (bank narrower than one 128-lane chunk)
    for dt in (torch.bfloat16, torch.float32):
        small = {"down_w": torch.randn((4, 128, 32), generator=gen),
                 "up_w": torch.randn((4, 32, 128), generator=gen),
                 "norm_scale": 1 + 0.1 * torch.randn((4, 128), generator=gen)}
        small = {k: (v / math.sqrt(v.shape[1])).to(dt).to(dev)
                 for k, v in small.items()}
        widths, bits = [32, 16, 24, 8], [8, 4, 1, 0]
        for i, w in enumerate(widths):
            small["down_w"][i, :, w:] = 0
            small["up_w"][i, w:, :] = 0
        small["width"] = torch.tensor(widths, dtype=torch.int32, device=dev)
        small["bits"] = torch.tensor(bits, dtype=torch.int32, device=dev)
        x = torch.randn((8, 1, 128), generator=gen).to(dt).to(dev)
        cases.append((f"{dtype_name(dt)} reduced bank wmax 32", small, x,
                      (torch.arange(8) % 5).to(dev)))
    worst, rows = 0.0, []
    for label, bank, x, modes in cases:
        e, r = check_boundary(bank, x, modes, label)
        worst = max(worst, e)
        rows.append({"case": label, "max_abs_err": e, "envelope_ratio": r})

    # timing at each main path's decode shape (qwen2.5-3b: width 512,
    # recurrentgemma-2b: width 640, both 8 bits); qwen's is the headline
    timed = time_boundary(cap, cfg.d_model, dev, seed, iters)
    out = {"phase": "kernel", "name": "boundary_mixed_grouped",
           "tolerance": TOL["boundary"], "cases": rows,
           "max_abs_err": worst, **timed, "library_ms": None,
           rcfg.name: time_boundary(rcap, rcfg.d_model, dev, seed, iters)}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# kernel 2: the fused decode tail
# ---------------------------------------------------------------------------

def check_tail(x, scale, head, label, expect=None, bias=None,
               norm_kind="rmsnorm", tied=False):
    """Kernel tokens (through the dispatcher) against the plain logits.
    ``tied``: ``head`` is the [1, V, d] embedding table."""
    import torch
    from repro_torch.kernels import ops, ref
    tk = ops.decode_tail_op(x, scale, bias, head, norm_kind=norm_kind,
                            tied=tied)
    torch.cuda.synchronize()
    tr = ref.decode_tail_ref(x, scale, bias, head, norm_kind=norm_kind,
                             tied=tied)
    xn = ref._final_norm(x.float(), scale, bias, norm_kind).to(x.dtype)
    w = head[0].float()
    logits = xn.float()[:, 0] @ (w.t() if tied else w)           # [n, V]
    del w
    lmax = logits.amax(-1)
    picked = logits.gather(1, tk[:, 0:1].long())[:, 0]
    gap = (lmax - picked) / lmax.abs().clamp(min=1e-30)
    bad = (tk[:, 0] != tr[:, 0]) & (gap > TOL["tail_rel_gap"])
    check(not bool(bad.any()),
          f"tail {label}: {int(bad.sum())} tokens differ beyond a near-tie")
    abs_gap = float((lmax - picked).max())
    if expect is not None:
        check(int(tk[0, 0]) == expect and int(tr[0, 0]) == expect,
              f"tail {label}: exact tie resolved to {int(tk[0, 0])} "
              f"(plain {int(tr[0, 0])}), expected the lowest index {expect}")
    return int((tk != tr).sum()), abs_gap


def phase_tail(cap, rcap, cfg, dev, seed: int, iters: int):
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.boundary_mixed import decode_tail_grouped
    params = cap["params"]
    head = params["lm_head"]["w"][None]                        # [1, d, V]
    scale = params["final_norm"]["scale"]
    V = head.shape[2]
    rows = []
    for n in (1, 3, 13, 32):
        x = pick_rows(cap["x_dec"], cap["valid"], n, seed + 100 + n)
        diff, gap = check_tail(x, scale, head, f"bf16 pool {n}")
        rows.append({"case": f"bfloat16 pool {n}", "tokens_differing": diff,
                     "max_abs_err": gap})
    # the layernorm family (+ bias) of the final norm, on the same head
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    bias = (0.1 * torch.randn(scale.shape, generator=gen, device=dev)).to(
        scale.dtype)
    x = pick_rows(cap["x_dec"], cap["valid"], 8, seed + 150)
    diff, gap = check_tail(x, scale, head, "bf16 layernorm pool 8",
                           bias=bias, norm_kind="layernorm")
    rows.append({"case": "bfloat16 layernorm pool 8",
                 "tokens_differing": diff, "max_abs_err": gap})
    # an exact tie: row 0's winning column copied to a lower index and to a
    # later vocab tile; the lowest index must win on both sides
    x = pick_rows(cap["x_dec"], cap["valid"], 8, seed + 200)
    top = int(ref.decode_tail_ref(x, scale, None, head)[0, 0])
    low = 5 if top > 5 else top
    tied = head.clone()
    tied[0, :, low] = head[0, :, top]
    tied[0, :, (top + V // 2) % V] = head[0, :, top]
    check_tail(x, scale, tied, "bf16 exact tie", expect=low)
    rows.append({"case": "bfloat16 exact tie", "expected": low})
    del tied
    x32 = x.float()
    head32 = head.float()
    diff, gap = check_tail(x32, scale.float(), head32, "f32 pool 8")
    rows.append({"case": "float32 pool 8", "tokens_differing": diff,
                 "max_abs_err": gap})
    del head32

    # timing at the main path's decode shape: 4 rows, one head
    x4 = pick_rows(cap["x_dec"], cap["valid"], 4, seed + 300)
    dest, hid_g, P = ops.head_layout(torch.zeros(4, dtype=torch.int32,
                                                 device=dev), 1, 16)
    xp = torch.zeros((P, x4.shape[-1]), dtype=x4.dtype, device=dev)
    xp[dest] = x4[:, 0]
    bias = torch.zeros_like(scale)
    parts = {}
    ms = time_ms(lambda: decode_tail_grouped(xp, head, scale, bias, hid_g,
                                             block_r=16, n_blocks=1), iters,
                 by_kernel=parts)
    plain = time_ms(lambda: ref.decode_tail_ref(x4, scale, None, head), iters)
    d = x4.shape[-1]
    b_ms, b_by = bound(2 * (V * d + 4 * d + 2 * d) + 4 * 4, 2 * 4 * d * V,
                       "bfloat16")
    tied = tail_tied(rcap, dev, seed, iters, rows)
    out = {"phase": "kernel", "name": "decode_tail_grouped",
           "tolerance": f"tokens equal except near-ties (relative top-two "
                        f"gap < {TOL['tail_rel_gap']}); exact tie -> lowest "
                        f"index", "cases": rows,
           "max_abs_err": max(r.get("max_abs_err", 0.0) for r in rows),
           "timed_shape": {"rows": 4, "d": d, "V": V},
           "ms": ms, "ms_by_kernel": parts, "plain_ms": plain,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "tied": tied}
    emit(out)
    return out


def tail_tied(rcap, dev, seed: int, iters: int, rows: list):
    """The tied layout: recurrentgemma-2b's [V, d] embedding table (V
    256000, d 2560), read in place. Tokens against the plain logits, an
    injected exact tie, the memory one call allocates (a per-call
    transpose of the table would take 1.31 GB), and the timing at the
    main path's 4 rows."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.boundary_mixed import decode_tail_grouped
    params = rcap["params"]
    table = params["embed"]["table"]
    head = table[None]                                         # [1, V, d]
    scale = params["final_norm"]["scale"]
    V, d = table.shape
    for n in (1, 4, 13):
        x = pick_rows(rcap["x_dec"], rcap["valid"], n, seed + 400 + n)
        diff, gap = check_tail(x, scale, head, f"tied bf16 pool {n}",
                               tied=True)
        rows.append({"case": f"tied bfloat16 pool {n}",
                     "tokens_differing": diff, "max_abs_err": gap})
    x = pick_rows(rcap["x_dec"], rcap["valid"], 8, seed + 500)
    top = int(ref.decode_tail_ref(x, scale, None, head, tied=True)[0, 0])
    low = 5 if top > 5 else top
    tied = table.clone()
    tied[low] = table[top]
    tied[(top + V // 2) % V] = table[top]
    check_tail(x, scale, tied[None], "tied bf16 exact tie", expect=low,
               tied=True)
    rows.append({"case": "tied bfloat16 exact tie", "expected": low})
    del tied
    x4 = pick_rows(rcap["x_dec"], rcap["valid"], 4, seed + 600)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.decode_tail_op(x4, scale, None, head, tied=True)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    check(extra < 64 << 20, f"tied tail: one call allocated {extra} bytes "
                            f"(a copy of the table?)")
    dest, hid_g, P = ops.head_layout(torch.zeros(4, dtype=torch.int32,
                                                 device=dev), 1, 16)
    xp = torch.zeros((P, d), dtype=x4.dtype, device=dev)
    xp[dest] = x4[:, 0]
    bias = torch.zeros_like(scale)
    parts = {}
    ms = time_ms(lambda: decode_tail_grouped(xp, head, scale, bias, hid_g,
                                             block_r=16, n_blocks=1,
                                             tied=True), iters,
                 by_kernel=parts)
    plain = time_ms(lambda: ref.decode_tail_ref(x4, scale, None, head,
                                                tied=True),
                    max(iters // 5, 3))
    b_ms, b_by = bound(2 * (V * d + 4 * d + 2 * d) + 4 * 4, 2 * 4 * d * V,
                       "bfloat16")
    return {"timed_shape": {"rows": 4, "d": d, "V": V, "layout": "[V, d]"},
            "ms": ms, "ms_by_kernel": parts, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by,
            "call_extra_bytes": int(extra)}


# ---------------------------------------------------------------------------
# kernel 3: paged decode attention
# ---------------------------------------------------------------------------

def decode_query(cap, cfg, layer: int, pos):
    """Layer ``layer``'s rope'd query for a decode at ``pos`` [B], from the
    encoder output rows at those positions."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.layers import apply_rope, norm_apply
    p = T.layer_slice(cap["params"]["layers"], layer)
    B = pos.shape[0]
    h = cap["x_enc"][torch.arange(B, device=pos.device), pos.long()][:, None]
    q, _, _ = _project_qkv(p["mix"], norm_apply(p["norm1"], h, cfg.norm),
                           cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    return apply_rope(q, pos.reshape(B, 1), cfg.rope_theta)[:, 0].contiguous()


def sdpa_ms(q, kp, vp, bt, pos, iters, flush):
    """One ``scaled_dot_product_attention`` call on the same K/V gathered
    into logical order (the gather is done once, outside the timing)."""
    import torch
    import torch.nn.functional as F
    B, nq, hd = q.shape
    nb, plen, n_kv = bt.shape[1], kp.shape[1], kp.shape[2]
    k = kp[bt.long()].reshape(B, nb * plen, n_kv, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(B, nb * plen, n_kv, hd).transpose(1, 2)
    k = k.repeat_interleave(nq // n_kv, 1).contiguous()
    v = v.repeat_interleave(nq // n_kv, 1).contiguous()
    mask = (torch.arange(nb * plen, device=q.device)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qq = q[:, :, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask), iters, flush)


def phase_paged(cap, cfg, dev, seed: int, iters: int):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention
    layer = cfg.split.split_at - 1
    kp, vp = cap["arena"]["k"][layer], cap["arena"]["v"][layer]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    # junk in scratch page 0: a masked read of it must not show
    kp[0] = torch.randn(kp[0].shape, generator=gen, device=dev).to(kp.dtype)
    vp[0] = torch.randn(vp[0].shape, generator=gen, device=dev).to(vp.dtype)
    lens = torch.from_numpy(cap["lens"]).to(dev)
    pos = (lens - 1).to(torch.int32)
    q = decode_query(cap, cfg, layer, pos)
    bt = cap["bt"]
    rows = []
    for dt, tol in ((torch.bfloat16, TOL["paged_bf16_abs"]),
                    (torch.float32, TOL["paged_f32_abs"])):
        qd, kd, vd = q.to(dt), kp.to(dt), vp.to(dt)
        out = paged_attention(qd, kd, vd, bt, pos)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(qd, kd, vd, bt, pos)
        err = float((out.float() - want.float()).abs().max())
        check(bool(torch.isfinite(out.float()).all()) and err <= tol,
              f"paged attention {dtype_name(dt)}: max error {err} > {tol}")
        rows.append({"case": f"{dtype_name(dt)} positions "
                             f"{[int(p) for p in pos]}", "max_abs_err": err,
                     "tolerance": tol})
    flush = l2_flusher(dev)
    long_ms = time_ms(lambda: paged_attention(q, kp, vp, bt, pos), iters,
                      flush)
    # timing at the main path's decode shape: 4 slots at positions the
    # 16-token prompts reach while generating 16 tokens
    seqs = torch.tensor([0, 4, 5, 7], device=dev)
    pos4 = torch.tensor([16, 20, 24, 31], dtype=torch.int32, device=dev)
    bt4 = bt[seqs][:, :4].contiguous()
    q4 = decode_query(cap, cfg, layer, pos4)
    ms = time_ms(lambda: paged_attention(q4, kp, vp, bt4, pos4), iters, flush)
    plain = time_ms(lambda: ref.paged_attention_ref(q4, kp, vp, bt4, pos4),
                    max(iters // 5, 3), flush)
    lib = sdpa_ms(q4, kp, vp, bt4, pos4, iters, flush)
    plen, n_kv, hd, nq = kp.shape[1], kp.shape[2], kp.shape[3], q4.shape[1]
    pages = sum(int(p) // plen + 1 for p in pos4)
    nbytes = (2 * 2 * 4 * nq * hd + pages * plen * n_kv * hd * 2 * 2
              + bt4.numel() * 4 + 4 * 4)
    flops = sum(4 * nq * hd * (int(p) + 1) for p in pos4)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    out = {"phase": "kernel", "name": "paged_attention",
           "tolerance": f"bf16 {TOL['paged_bf16_abs']} abs, f32 "
                        f"{TOL['paged_f32_abs']} abs", "cases": rows,
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "timed_shape": {"B": 4, "positions": [int(p) for p in pos4],
                           "nq": nq, "n_kv": n_kv, "hd": hd, "page_len": plen},
           "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib, "library_call": "scaled_dot_product_attention "
                                              "on the gathered K/V",
           "ms_positions_up_to_999": long_ms}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# kernel 4: the RG-LRU scan
# ---------------------------------------------------------------------------

def phase_rglru(rcap, dev, iters: int):
    """Every captured shape bit for bit against the plain version; device
    ms of the kernel and of the plain version at the main path's prefill
    shape [4, 16, D] and at a window-long prompt [4, 2048, D]. No single
    PyTorch call computes this recurrence, so there is no library time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_scan
    rows = []
    for label, (a, b, h0) in rcap["scans"].items():
        hk = rglru_scan(a, b, h0)
        torch.cuda.synchronize()
        hr = ref.rglru_scan_ref(a, b, h0)
        err = float((hk - hr).abs().max())
        check(torch.equal(hk, hr) and bool(torch.isfinite(hk).all()),
              f"rglru_scan {label}: not bit for bit (max error {err})")
        rows.append({"case": label, "shape": list(a.shape),
                     "h0": h0 is not None, "max_abs_err": err})
    flush = l2_flusher(dev)

    def timed(key, n_iters, n_plain):
        a, b, h0 = rcap["scans"][key]
        B, S, D = a.shape
        ms = time_ms(lambda: rglru_scan(a, b, h0), n_iters, flush)
        plain = time_ms(lambda: ref.rglru_scan_ref(a, b, h0), n_plain, flush)
        b_ms, b_by = bound(3 * B * S * D * 4 + (B * D * 4 if h0 is not None
                                                else 0),
                           2 * B * S * D, "float32")
        return {"timed_shape": [B, S, D], "ms": ms, "plain_ms": plain,
                "bound_ms": b_ms, "bound_by": b_by}

    head = timed("[4, 16] main-path prefill", iters, max(iters // 5, 3))
    long = timed("[4, 2048] prefill, no h0", max(iters // 5, 3), 2)
    out = {"phase": "kernel", "name": "rglru_scan",
           "tolerance": TOL["rglru"], "cases": rows,
           "max_abs_err": max(r["max_abs_err"] for r in rows), **head,
           "library_ms": None,
           "window_prompt": long}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the serving entry point
# ---------------------------------------------------------------------------

SERVE_COMMON = ["--engine", "continuous", "--requests", "8", "--prompt-len",
                "16", "--gen", "16", "--n-slots", "4"]
SERVE = {"qwen2.5-3b": ["--arch", "qwen2.5-3b", *SERVE_COMMON],
         "recurrentgemma-2b": ["--arch", "recurrentgemma-2b", *SERVE_COMMON,
                               "--cache-len", "2048"]}


def phase_reference(arch: str, device: str = "cuda"):
    """The serving entry point at reduced shapes in f32 on the card and on
    the CPU, on the same weights (drawn on the CPU and copied, since the
    two devices' generators draw different numbers). With every request on
    mode 0 (a fast uplink) nothing is quantized, so the tokens must be
    equal: f32 sums in two orders leave argmax ties far apart. With mixed
    modes (a slow uplink) the modes and wire bytes must be equal; the
    tokens may part where a code of the 8-bit wire sits on a rounding edge
    and the two sides' sums round it differently, so their agreement is
    reported, not required."""
    import dataclasses

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import split as SP
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    cpu = SP.init_split_params(torch.Generator().manual_seed(0), cfg)
    gpu = T.tree_map(lambda t: t.to(device), cpu)
    out = {"phase": "reference", "arch": arch}
    for label, mbps in (("mode0", "1000"), ("mixed", "1")):
        args = SERVE[arch] + ["--reduced", "--mean-mbps", mbps, "--device"]
        got = serve.run_continuous(serve.parser().parse_args(args + [device]),
                                   cfg, gpu)
        want = serve.run_continuous(serve.parser().parse_args(args + ["cpu"]),
                                    cfg, cpu)
        for k in ("mode_counts", "wire_bytes", "decode_ticks"):
            check(got[k] == want[k], f"reduced f32 {label}: {k} differs")
        toks = [(got["tokens"][r], want["tokens"][r]) for r in want["tokens"]]
        same = sum(a == b for a, b in toks)
        first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                      None) for a, b in toks]
        if label == "mode0":
            check(set(got["mode_counts"]) == {0} and same == len(toks),
                  f"reduced f32 mode 0: {len(toks) - same} requests decode "
                  f"other tokens on the card (first differing index "
                  f"{first})")
        out[label] = {"mode_counts": got["mode_counts"],
                      "wire_bytes": got["wire_bytes"],
                      "requests_with_equal_tokens": same,
                      "requests": len(toks), "first_differing_index": first}
    emit(out)


def kernel_fns():
    from repro_torch.kernels.boundary_mixed import (boundary_mixed_grouped,
                                                    decode_tail_grouped)
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    return {"boundary_mixed_grouped": boundary_mixed_grouped,
            "decode_tail_grouped": decode_tail_grouped,
            "paged_attention": paged_attention,
            "rglru_scan": rglru_scan}


@contextlib.contextmanager
def counting(module, name: str, counts: dict):
    """Count the calls of ``module.name`` while the block runs."""
    orig = getattr(module, name)

    def counted(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return orig(*args, **kw)

    setattr(module, name, counted)
    try:
        yield counts
    finally:
        setattr(module, name, orig)


def phase_main_path(cfg, smi: str):
    """The arch's serving entry point at full width with every launch
    counter at 0 just before and read just after, prefill dispatches and
    decode ticks counted beside them (warm-up included). Per decode tick
    the device loop launches one boundary, one tail and one paged
    attention per layer on the paged pool; per prefill dispatch one
    boundary and one scan per RG-LRU layer."""
    from repro_torch.core import split as SP
    from repro_torch.launch import serve
    fns = kernel_fns()
    for f in fns.values():
        f.launches = 0
    calls: dict = {}
    with counting(SP, "split_prefill_mixed", calls), \
            counting(SP, "split_decode_step_mixed", calls):
        summary = serve.main(SERVE[cfg.name] + ["--device", "cuda"])
    launches = {k: f.launches for k, f in fns.items()}
    prefills = calls.get("split_prefill_mixed", 0)
    ticks = calls.get("split_decode_step_mixed", 0)
    toks = summary["tokens"]
    check(summary["requests_finished"] == 8 and len(toks) == 8,
          f"main path: {summary['requests_finished']} of 8 requests finished")
    for rid, t in toks.items():
        check(len(t) == 16 and all(0 <= v < cfg.vocab_size for v in t),
              f"main path: request {rid} returned {len(t)} tokens")
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    expect = {"boundary_mixed_grouped": ticks + prefills,
              "decode_tail_grouped": ticks,
              "paged_attention": (kinds.count("attn") * ticks
                                  if summary["paged"] else 0),
              "rglru_scan": kinds.count("rglru") * prefills}
    for k, n in expect.items():
        if n:
            check(launches[k] > 0, f"main path: kernel {k} never launched")
    check(launches == expect,
          f"main path {cfg.name}: launches {launches} for {prefills} "
          f"prefill dispatches and {ticks} decode ticks, expected {expect}")
    emit({"phase": "main_path", "arch": cfg.name, "dtype": cfg.dtype,
          "paged": summary["paged"],
          "requests_finished": summary["requests_finished"],
          "decode_tokens": summary["decode_tokens"],
          "decode_ticks": summary["decode_ticks"],
          "seconds": summary["seconds"],
          "decode_tok_per_s": summary["decode_tok_per_s"],
          "mode_counts": summary["mode_counts"], "launches": launches,
          "prefill_dispatches": prefills, "decode_step_calls": ticks,
          "card": smi})
    return launches


def phase_profile(cfg):
    """The arch's main path once more, traced with ``torch.profiler`` (its
    rate is not the one reported above): device busy time, idle share,
    launches per decode tick and the kernels that take the time. The
    Chrome trace lands in build/profile/<arch>."""
    from repro_torch.launch import serve
    summary = serve.main(SERVE[cfg.name] + [
        "--device", "cuda", "--profile-dir",
        str(ROOT / "build" / "profile" / cfg.name)])
    prof = summary["profile"]
    emit({"phase": "profile", "arch": cfg.name,
          "decode_ticks": summary["decode_ticks"],
          "launches_per_decode_tick": (prof["kernel_launches"]
                                       / max(summary["decode_ticks"], 1)),
          **prof})


SOURCES = {
    "boundary_mixed_grouped": "src/repro_torch/csrc/boundary_mixed.cu",
    "decode_tail_grouped": "src/repro_torch/csrc/boundary_mixed.cu",
    "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
    "rglru_scan": "src/repro_torch/csrc/rglru_scan.cu",
}
REPLACES = {
    "boundary_mixed_grouped": "src/repro/kernels/boundary_mixed.py:196",
    "decode_tail_grouped": "src/repro/kernels/boundary_mixed.py:143",
    "paged_attention": "src/repro/kernels/paged_attention.py:82",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:42",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random full-width weights")
    ap.add_argument("--iters", type=int, default=50,
                    help="timed launches per kernel")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs)})

    cfg = get_config("qwen2.5-3b")
    rcfg = get_config("recurrentgemma-2b")
    t0 = time.perf_counter()
    cap = capture(cfg, dev, args.seed)
    emit({"phase": "capture", "arch": cfg.name,
          "seconds": time.perf_counter() - t0,
          "lengths": [int(n) for n in cap["lens"]]})
    t0 = time.perf_counter()
    rcap = capture_recurrent(rcfg, dev, args.seed)
    emit({"phase": "capture", "arch": rcfg.name,
          "seconds": time.perf_counter() - t0, "lengths": list(RLENS)})
    results = {}
    for r in (phase_boundary(cap, rcap, cfg, rcfg, dev, args.seed,
                             args.iters),
              phase_tail(cap, rcap, cfg, dev, args.seed, args.iters),
              phase_paged(cap, cfg, dev, args.seed, args.iters),
              phase_rglru(rcap, dev, args.iters)):
        results[r["name"]] = r
    del cap, rcap
    gc.collect()
    torch.cuda.empty_cache()

    by_path = {}
    for c in (cfg, rcfg):
        phase_reference(c.name)
        by_path[c.name] = phase_main_path(c, smi)
        phase_profile(c)

    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name],
         "launches": sum(p[name] for p in by_path.values()),
         "launches_by_path": {a: p[name] for a, p in by_path.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in results.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
