"""Benchmark harness — one entry per paper table/figure (the reference
package's ``benchmarks/run.py`` over the port's benches):

  bench_cascade      Alg. 1 / Fig. 9: per-mode payload vs predictive quality
  bench_modes        Fig. 3/5: dynamic switching vs static policies
  bench_kernels      kernel layer micro-bench + wire compression
  bench_temporal_mi  Figs. 7-8 + Sec. VI: temporal MI + conditional ladder
  bench_infoplane    Fig. 9: information-plane trajectories, both phases
  bench_roofline     roofline table from the dry run's records

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cuda|cpu]

Each suite prints ``name,us_per_call,derived`` CSV lines. ``--device``
(default ``cuda``, which raises without a card) goes to the suites that
take one.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import traceback

#: (name, module, takes --device), in the reference's order
SUITES = [
    ("cascade", "repro_torch.benchmarks.bench_cascade", True),
    ("modes", "repro_torch.benchmarks.bench_modes", False),
    ("kernels", "repro_torch.benchmarks.bench_kernels", True),
    ("temporal_mi", "repro_torch.benchmarks.bench_temporal_mi", True),
    ("infoplane", "repro_torch.benchmarks.bench_infoplane", True),
    ("roofline", "repro_torch.benchmarks.bench_roofline", False),
]


def run_suite(name: str, device: str = "cuda"):
    """Run one suite of ``SUITES`` by name through its ``main``; returns
    what ``main`` returns."""
    _, module, takes = next(s for s in SUITES if s[0] == name)
    main = importlib.import_module(module).main
    return main(["--device", device] if takes else [])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--suites", default=None,
                    help="comma-separated subset of the suites, in the "
                         "table's order (default: all)")
    args = ap.parse_args(argv)
    names = [s[0] for s in SUITES]
    if args.suites:
        want = args.suites.split(",")
        unknown = sorted(set(want) - set(names))
        if unknown:
            ap.error(f"unknown suites {unknown}; known: {names}")
        names = [n for n in names if n in want]
    failed = []
    for name in names:
        print(f"# --- {name} ---", flush=True)
        try:
            run_suite(name, args.device)
        except Exception:                       # noqa: BLE001
            failed.append(name)
            traceback.print_exc()
    if failed:
        print(f"# FAILED suites: {failed}")
        sys.exit(1)
    print("# all benchmark suites completed")


if __name__ == '__main__':
    main()
