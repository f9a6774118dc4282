"""Roofline table: reads the dry run's records (``results/dryrun_torch/
*.json``, produced by ``python -m repro_torch.launch.dryrun``, or another
directory) and prints the per-(arch x shape x mesh) three-term roofline on
the H100's published peaks with the dominant bottleneck and the
useful-FLOPs ratio (the reference package's ``benchmarks/
bench_roofline.py``, line for line).

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_roofline [DIR]
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Optional

from repro_torch.launch.dryrun import RESULTS_DIR


def load_all(results_dir: Optional[str] = None) -> List[Dict]:
    rows = []
    for f in sorted(glob.glob(os.path.join(results_dir or RESULTS_DIR,
                                           "*.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def lines(results_dir: Optional[str] = None) -> List[str]:
    rows = load_all(results_dir)
    if not rows:
        return ["roofline_table,0,no dryrun results — run "
                "`PYTHONPATH=src python -m repro_torch.launch.dryrun` first"]
    out = []
    for d in rows:
        r = d["roofline"]
        name = f"{d['arch']}|{d['shape']}|{d['mesh']}"
        if d.get("variant", "baseline") != "baseline":
            name += f"|{d['variant']}"
        if not d.get("seq_shard", True):
            name += "|noseqshard"
        out.append(f"roofline_{name},{r['bound_s']*1e6:.0f},"
                   f"c={r['compute_s']*1e3:.1f}ms "
                   f"m={r['memory_s']*1e3:.1f}ms "
                   f"coll={r['collective_s']*1e3:.1f}ms "
                   f"dom={r['dominant'][:-2]} "
                   f"useful={d['useful_ratio']:.2f}")
    return out


def main(argv=None) -> List[str]:
    argv = sys.argv[1:] if argv is None else argv
    out = lines(argv[0] if argv else None)
    for line in out:
        print(line)
    return out


if __name__ == "__main__":
    main()
