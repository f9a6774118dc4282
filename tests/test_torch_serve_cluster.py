"""The port's scale-out entry points against the JAX package's.

``launch.serve --engine cluster|fleet`` and the three serving benches
(``bench_serving``, ``bench_cluster``, ``bench_fleet``) run at reduced
shapes on the CPU in both packages with the same arguments. Every mode
choice, admission and migration depends only on the simulated channels
and token counts, never on token values, so everything but wall-clock
times must agree: the JSON keys of every section, and every non-timing
value (finished, rejected and replayed requests, wire bytes, modes,
ticks, migrations and their bytes, scale events, trace event counts).
The reference's runs go in one subprocess, in parallel with the port's.
Without a card ``--device cuda`` raises; the serving mesh's ``--dp`` /
``--mp`` and ``--slot-scaling`` raise where the backend cannot run the
layout (their runs are in ``tests/test_torch_sharded_serving.py``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import bench_cluster, bench_fleet, bench_serving
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]

SERVE = {
    "cluster": ["--arch", "qwen2.5-3b", "--reduced", "--engine", "cluster",
                "--requests", "6", "--gen", "6", "--prompt-len", "4",
                "--n-slots", "2", "--placement", "best-channel",
                "--snapshot-bits", "8", "--telemetry"],
    "fleet": ["--arch", "qwen2.5-3b", "--reduced", "--engine", "fleet",
              "--requests", "16", "--gen", "4", "--prompt-len", "4",
              "--n-slots", "2", "--replicas", "1", "--arrival-every", "1",
              "--slo-ticks", "12", "--autoscale", "--max-replicas", "3",
              "--telemetry"],
}
BENCH = {
    "serving": ["--loads", "4,1", "--requests", "3", "--gen", "3",
                "--n-slots", "2", "--prefill-prompt-len", "4",
                "--compare-slots", "1", "--compare-gen", "3",
                "--overhead-repeats", "1", "--channel-trace", "fade",
                "--trace-gen", "6"],
    "cluster": ["--n-slots", "1", "--gen", "4"],
    "fleet": ["--ues", "8,16", "--ab-ues", "16", "--n-slots", "2", "--gen",
              "3", "--max-replicas", "3"],
}
#: wall-clock values (and what is derived from them), the paths of the
#: artifacts, and the port's own fields
TIMING = {"decode_tok_per_s", "prefill_tok_per_s", "ttft_loop_ms",
          "ttft_batched_ms", "ttft_speedup", "mean_ttft_ms", "mean_ttft_s",
          "decode_speedup", "plain_tok_per_s", "telemetry_tok_per_s",
          "ratio", "latency", "wall_s", "ttft_s", "path", "trace_out",
          "tokens", "device", "reduced", "seconds"}

REFERENCE = r"""
import json, sys
from pathlib import Path
out = Path(sys.argv[1])
sys.path.insert(0, sys.argv[2])
import importlib.util
def load(name):
    spec = importlib.util.spec_from_file_location(name, sys.argv[3] + "/" + name + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
from repro.launch import serve
cfg = json.loads(sys.argv[4])
for name, argv in cfg["serve"].items():
    json.dump(serve.main(argv), open(out / f"serve_{name}.json", "w"), default=str)
for name, argv in cfg["bench"].items():
    extra = ["--trace-out", str(out / "trace.json")] if name == "serving" else []
    load("bench_" + name).main(argv + extra + ["--json", str(out / f"bench_{name}.json")])
"""


def _strip(obj):
    """JSON round trip (int keys become strings, tuples lists) with the
    timing fields dropped at every depth."""
    obj = json.loads(json.dumps(obj, default=str))

    def walk(o):
        if isinstance(o, dict):
            return {k: walk(v) for k, v in o.items() if k not in TIMING}
        if isinstance(o, list):
            return [walk(v) for v in o]
        return o

    return walk(obj)


def _keys(o, prefix=""):
    """Every key path of a JSON document (list items merged)."""
    out = set()
    if isinstance(o, dict):
        for k, v in o.items():
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    elif isinstance(o, list):
        for v in o:
            out |= _keys(v, prefix)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's launcher and benches in a subprocess, the port's
    here, at the same arguments, at the same time."""
    ref_dir = tmp_path_factory.mktemp("reference")
    port_dir = tmp_path_factory.mktemp("port")
    # one compute thread: the reference runs beside the port's and beside
    # the other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(ref_dir), str(ROOT / "src"),
         str(ROOT / "benchmarks"),
         json.dumps({"serve": SERVE, "bench": BENCH})],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    port = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # reduced shapes: one thread is enough
    try:
        for name, argv in SERVE.items():
            port[f"serve_{name}"] = serve.main(argv + ["--device", "cpu"])
        for name, mod in (("serving", bench_serving),
                          ("cluster", bench_cluster), ("fleet", bench_fleet)):
            extra = (["--trace-out", str(port_dir / "trace.json")]
                     if name == "serving" else [])
            port[f"bench_{name}"] = mod.main(
                BENCH[name] + extra + ["--reduced", "--device", "cpu"])
        _, err = proc.communicate(timeout=600)
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    ref = {p.stem: json.load(open(p)) for p in ref_dir.glob("*.json")
           if p.stem != "trace"}
    return ref, port, ref_dir / "trace.json", port_dir / "trace.json"


@pytest.mark.parametrize("name", ["serve_cluster", "serve_fleet",
                                  "bench_serving", "bench_cluster",
                                  "bench_fleet"])
def test_keys_and_values_match_reference(name, runs):
    ref, port, _, _ = runs
    want, got = _strip(ref[name]), _strip(port[name])
    assert _keys(ref[name]) <= _keys(json.loads(json.dumps(
        port[name], default=str)))
    assert {k: got[k] for k in want} == want


def test_runs_did_the_work(runs):
    """The cluster migrated at 8 bits, the fleet admitted and autoscaled,
    every bench section is there."""
    _, port, ref_trace, port_trace = runs
    c = port["serve_cluster"]
    assert c["requests_finished"] == 6 and c["migrations"] > 0
    assert c["snapshot_bits"] == 8
    assert c["latency"]["cluster.migration_backhaul_s"]["count"] == \
        c["migrations"]
    f = port["serve_fleet"]
    cons = f["conservation"]
    assert cons["submitted"] == 16 and cons["in_flight"] == 0
    assert f["requests_finished"] + f["slo_rejected"] + \
        f["requests_rejected"] == 16
    assert {"prefill_comparison", "levels", "long_prompt",
            "engine_comparison", "telemetry_overhead",
            "cluster_trace_export", "channel_trace"} <= \
        set(port["bench_serving"])
    lat = port["bench_serving"]["levels"][0]["latency"]
    assert lat["engine.ttft_s"]["count"] == 3
    assert port["bench_cluster"]["handover_ab"]["migrate"]["migrations"] > 0
    want = json.load(open(ref_trace))["traceEvents"]
    got = json.load(open(port_trace))["traceEvents"]
    assert [(e["name"], e["pid"]) for e in got] == \
        [(e["name"], e["pid"]) for e in want]


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((serve.main, SERVE["cluster"]),
                       (serve.main, SERVE["fleet"]),
                       (bench_serving.main, BENCH["serving"]),
                       (bench_cluster.main, BENCH["cluster"]),
                       (bench_fleet.main, BENCH["fleet"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv + ["--reduced"] if main is not serve.main else argv)


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--mp", "2"]])
def test_serving_mesh_raises(flag):
    """The serving mesh raises where its backend cannot run the layout
    (NCCL takes no CPU ranks; it is never swapped for gloo), and for an
    axis under 1."""
    with pytest.raises(ValueError, match="nccl"):
        serve.main(SERVE["cluster"] + ["--device", "cpu", "--dist-backend",
                                       "nccl"] + flag)
    with pytest.raises(ValueError, match="axes"):
        serve.main(SERVE["cluster"] + ["--device", "cpu"]
                   + [flag[0], "0"])


def test_slot_scaling_and_replica_meshes_raise():
    """``--slot-scaling`` refuses a backend that cannot run its ranks, and
    a cluster's replica meshes need ranks this process (no process group)
    does not have."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import split as SP
    from repro_torch.serving import EdgeCluster
    with pytest.raises(ValueError, match="nccl"):
        bench_serving.main(["--reduced", "--device", "cpu",
                            "--slot-scaling", "1,2", "--dist-backend",
                            "nccl"])
    cfg = get_reduced("qwen2.5-3b")
    params = SP.init_split_params(torch.Generator().manual_seed(0), cfg)
    for kw in ({"dp": 2}, {"mp": 2}, {"devices": ["cpu"]}):
        with pytest.raises(ValueError, match="device"):
            EdgeCluster(params, cfg, **kw)
