"""Kernel micro-benchmarks of the port (mirrors
``benchmarks/bench_kernels.py``): the wall time of each kernel's
dispatcher in ``kernels.ops``, which on ``cuda`` launches the hand-written
kernel and on ``cpu`` runs its plain PyTorch version; the wire-compression
ratio of the fused bottleneck-quant payload; the fused mixed-mode
boundary; and the fused decode tail against the unfused boundary + head +
argmax chain. The boundary is held against its plain version and the fused
tail's tokens against the unfused chain's; either failing raises.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_kernels \
        [--device cuda|cpu] [--json PATH]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card. Inputs are drawn with numpy from fixed seeds.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.serving.telemetry import block
from repro_torch.serving.telemetry import time_us as _time

WIDTHS_BITS = ((128, 8), (256, 4), (128, 1), (512, 0))


def _norm_logits(x, scale, heads):
    """Final rmsnorm rounded to the model dtype, then f32 logits."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    y = (y * scale.float()).to(x.dtype)
    return torch.einsum("bsd,dv->bsv", y.float(), heads[0].float())


def run(device="cuda", *, M: int = 512, K: int = 2048, N: int = 512,
        D: int = 2048, scan=(4, 1024, 512), d: int = 512, B: int = 32,
        V: int = 4096, iters: int = 20) -> Dict:
    """Time every kernel's dispatcher on ``device``. The defaults are the
    reference bench's shapes: the wire at qwen2.5-3b's widths in f32
    (M 512, K 2048, N 512, D 2048), the scan at [4, 1024, 512], a 32-slot
    boundary over four heads at d 512, and the tail at V 4096."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        a = scale * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    x = normal(M, K)
    w_down = normal(K, N, scale=0.02)
    w_up = normal(N, D, scale=0.02)
    us_bq = _time(ops.bottleneck_quant_op, x, w_down, iters=iters)
    codes, scales = ops.bottleneck_quant_op(x, w_down)
    us_dq = _time(ops.dequant_matmul_op, codes, scales, w_up, iters=iters)

    a = torch.sigmoid(normal(*scan))
    b = normal(*scan)
    us_rs = _time(ops.rglru_scan_op, a, b, iters=5)

    # fused mixed-mode boundary: a B-slot decode pool, every slot on its
    # own mode (the per-tick serving op)
    wmax = max(w for w, _ in WIDTHS_BITS)
    down = torch.zeros((len(WIDTHS_BITS), d, wmax))
    up = torch.zeros((len(WIDTHS_BITS), wmax, d))
    for i, (w, _) in enumerate(WIDTHS_BITS):
        down[i, :, :w] = normal(d, w, scale=0.05).cpu()
        up[i, :w, :] = normal(w, d, scale=0.05).cpu()
    stacked = {
        "down_w": down.to(torch.bfloat16).to(dev),
        "up_w": up.to(torch.bfloat16).to(dev),
        "norm_scale": torch.ones((len(WIDTHS_BITS), d), dtype=torch.bfloat16,
                                 device=dev),
        "width": torch.tensor([w for w, _ in WIDTHS_BITS], dtype=torch.int32,
                              device=dev),
        "bits": torch.tensor([b_ for _, b_ in WIDTHS_BITS],
                             dtype=torch.int32, device=dev),
    }
    xb = normal(B, 1, d).to(torch.bfloat16)
    modes = (torch.arange(B, dtype=torch.int32) % (len(WIDTHS_BITS) + 1)
             ).to(dev)
    us_bm = _time(ops.boundary_mixed_op, stacked, xb, modes, iters=iters)
    y_k = ops.boundary_mixed_op(stacked, xb, modes)
    y_r = ref.boundary_mixed_ref(stacked, xb, modes)
    bm_ok = bool(torch.isfinite(y_k.float()).all()
                 and (y_k.float() - y_r.float()).abs().max() < 0.05)

    # fused decode tail vs the unfused chain it replaced: the boundary,
    # then final norm + LM-head logits, then argmax, each waited for, with
    # the full [B, 1, V] f32 logits materialized between them
    heads = normal(1, d, V, scale=0.05).to(torch.bfloat16)
    nscale = torch.ones((d,), dtype=torch.bfloat16, device=dev)

    def unfused(s, x, m):
        y = ops.boundary_mixed_op(s, x, m)
        block(y)
        lg = _norm_logits(y, nscale, heads)
        block(lg)
        return torch.argmax(lg, dim=-1).to(torch.int32)

    def fused(s, x, m):
        return ops.decode_tail_op(ops.boundary_mixed_op(s, x, m), nscale,
                                  None, heads)

    us_unfused = _time(unfused, stacked, xb, modes, iters=iters)
    us_fused = _time(fused, stacked, xb, modes, iters=iters)
    mega_ok = bool(torch.equal(unfused(stacked, xb, modes),
                               fused(stacked, xb, modes)))

    raw_bytes = M * K * 2                          # boundary bf16
    wire_bytes = M * N * 1 + M * 2                 # int8 + scales
    return {
        "device": str(dev), "scan_shape": list(scan), "pool": B,
        "bottleneck_quant_us": us_bq, "dequant_matmul_us": us_dq,
        "rglru_scan_us": us_rs,
        "boundary_mixed_us": us_bm, "boundary_mixed_parity_ok": bm_ok,
        "mega_fused_tick_us": us_fused,
        "mega_unfused_chain_us": us_unfused,
        "mega_speedup": us_unfused / us_fused,
        "mega_parity_ok": mega_ok,
        "wire_compression": wire_bytes / raw_bytes,
    }


def main(argv=None):
    import argparse
    import json

    from repro_torch.launch.serve import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the hand-written "
                         "kernels; cpu: their plain versions)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the raw result dict as JSON")
    args = ap.parse_args(argv)

    out = run(resolve_device(args.device))
    print(f"kernel_bottleneck_quant,{out['bottleneck_quant_us']:.0f},"
          f"wire_ratio={out['wire_compression']:.4f}")
    print(f"kernel_dequant_matmul,{out['dequant_matmul_us']:.0f},decoder_side")
    Bs, S, Ds = out["scan_shape"]
    print(f"kernel_rglru_scan,{out['rglru_scan_us']:.0f},B{Bs}xS{S}xD{Ds}")
    print(f"kernel_boundary_mixed,{out['boundary_mixed_us']:.0f},"
          f"B{out['pool']}x{len(WIDTHS_BITS) + 1}modes,"
          f"parity_ok={out['boundary_mixed_parity_ok']}")
    print(f"kernel_mega_tick,{out['mega_fused_tick_us']:.0f},"
          f"unfused={out['mega_unfused_chain_us']:.0f},"
          f"speedup={out['mega_speedup']:.2f},"
          f"parity_ok={out['mega_parity_ok']}")
    if not out["boundary_mixed_parity_ok"]:
        raise AssertionError("boundary kernel diverged from its plain "
                             "version")
    if not out["mega_parity_ok"]:
        raise AssertionError("fused decode tail diverged from the unfused "
                             "boundary+head+argmax chain")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"kernels": out}, f, indent=2)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
