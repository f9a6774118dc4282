"""The §Roofline markdown table from the dry run's records
(``results/dryrun_torch/*.json``, or ``--results-dir``); the reference
package's ``benchmarks/gen_experiments.py``, row for row. Prints to
stdout.

    PYTHONPATH=src python -m repro_torch.benchmarks.gen_experiments \\
        [--mesh 16_16] [--variants] [--results-dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

from repro_torch.launch.dryrun import RESULTS_DIR

ARCH_ORDER = ["musicgen-large", "stablelm-3b", "llava-next-34b", "qwen2.5-3b",
              "phi3.5-moe-42b-a6.6b", "mixtral-8x7b", "internlm2-20b",
              "recurrentgemma-2b", "granite-8b", "xlstm-125m"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.0f}us"


def _records(results_dir: Optional[str]):
    for f in sorted(glob.glob(os.path.join(results_dir or RESULTS_DIR,
                                           "*.json"))):
        with open(f) as fh:
            yield json.load(fh)


def load(mesh: str, variants: bool = False,
         results_dir: Optional[str] = None):
    rows = []
    for d in _records(results_dir):
        if d.get("skipped"):
            continue
        is_variant = (d.get("variant", "baseline") != "baseline"
                      or not d.get("seq_shard", True)
                      or d.get("tp_scope", "all") != "all"
                      or bool(d.get("moe_ep"))
                      or bool(d.get("kv_bits")))
        if is_variant != variants:
            continue
        if d["mesh"].replace("x", "_") != mesh:
            continue
        rows.append(d)
    key = lambda d: (ARCH_ORDER.index(d["arch"]),      # noqa: E731
                     SHAPE_ORDER.index(d["shape"]))
    return sorted(rows, key=key)


def table(mesh: str, variants: bool = False,
          results_dir: Optional[str] = None) -> str:
    rows = load(mesh, variants, results_dir)
    out = ["| arch | shape | compute | memory | collective | dominant | "
           "useful | argGiB/dev | tempGiB/dev |",
           "|---|---|---:|---:|---:|---|---:|---:|---:|"]
    for d in rows:
        r = d["roofline"]
        ma = d.get("memory_analysis", {})
        tag = d["arch"]
        mods = []
        if d.get("variant", "baseline") != "baseline":
            mods.append(d["variant"])
        pol = d.get("act_policy", "seq" if d.get("seq_shard", True)
                    else "batch")
        if pol != "seq":
            mods.append(pol)
        if d.get("tp_scope", "all") != "all":
            mods.append(f"tp={d['tp_scope']}")
        if d.get("moe_ep"):
            mods.append("ep")
        if d.get("kv_bits"):
            mods.append(f"kv{d['kv_bits']}")
        if mods:
            tag += f" ({', '.join(mods)})"
        out.append(
            f"| {tag} | {d['shape']} | {fmt_s(r['compute_s'])} | "
            f"{fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} | "
            f"{r['dominant'][:-2]} | {d['useful_ratio']:.2f} | "
            f"{ma.get('argument_size_in_bytes', 0)/2**30:.2f} | "
            f"{ma.get('temp_size_in_bytes', 0)/2**30:.2f} |")
    return "\n".join(out)


def skipped_pairs(results_dir: Optional[str] = None) -> str:
    out = []
    for d in _records(results_dir):
        if d.get("skipped"):
            out.append(f"- {d['arch']} x {d['shape']}: {d['reason']}")
    return "\n".join(out)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16_16")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args(argv)
    out = table(args.mesh, args.variants, args.results_dir)
    print(out)
    return out


if __name__ == "__main__":
    main()
