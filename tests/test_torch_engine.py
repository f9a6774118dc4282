"""The port's continuous-batching engine against the JAX package's, and the
port's isolation from JAX.

Both engines serve the same requests (numpy prompts, per-request simulated
channels with the same seeds) on the reduced qwen2.5-3b config in float32
with weights converted from JAX's ``init_split_params``, through the paged
pool and the mixed-mode split path. Mode choice depends only on channels and
token counts, so per-tick modes, wire bytes and the tick-exact lifecycle
must be identical; the decoded tokens must be identical too (float32 logits
of the two packages differ by ~1e-6, far below any top-two gap these
weights produce). Each JAX engine runs once per module and loop kind.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import bottleneck as JB
from repro.core import split as JSP
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.channel import channel_fleet as j_fleet
from repro.core.orchestrator import (AppRequirement as JReq,
                                     ModeProfile as JProfile,
                                     Orchestrator as JOrch)
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import ControllerConfig as JCtlConfig
from repro.serving import ModeController as JController
from repro.serving import Request as JRequest
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core.channel import ChannelConfig as TChannelConfig
from repro_torch.core.channel import channel_fleet as t_fleet
from repro_torch.core.orchestrator import (AppRequirement as TReq,
                                           ModeProfile as TProfile,
                                           Orchestrator as TOrch)
from repro_torch.launch import serve
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import ControllerConfig as TCtlConfig
from repro_torch.serving import ModeController as TController
from repro_torch.serving import Request as TRequest

ROOT = Path(__file__).resolve().parents[1]
N_REQ = 10


def _cfgs():
    return (dataclasses.replace(j_reduced("qwen2.5-3b"), dtype="float32"),
            dataclasses.replace(t_reduced("qwen2.5-3b"), dtype="float32"))


def _requests(cfg, fleet, chan_cfg, request_cls):
    chans = fleet(N_REQ, chan_cfg(mean_mbps=0.5, std_mbps=0.4,
                                  blockage_prob=0.08, recovery_prob=0.15),
                  seed=11, mean_spread=0.95)
    rng = np.random.default_rng(3)
    out = []
    for i in range(N_REQ):
        plen = int(rng.integers(3, 12))
        out.append(request_cls(
            rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                       size=plen).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 10)), channel=chans[i],
            arrival_tick=i // 2))
    return out


def _orch(cfg, bn, profile, req, orch):
    return orch([profile(m, bn.mode_payload_bytes(cfg, 1, 1, m), float(m))
                 for m in range(cfg.split.n_modes)],
                req(latency_budget_s=0.006), ema=0.5, hysteresis=1.0)


def _summary(eng, done):
    st = eng.stats()
    per = {s.request.rid: {"tokens": list(s.tokens),
                           "mode_trace": [tuple(t) for t in s.mode_trace],
                           "mode_counts": dict(s.mode_counts),
                           "wire_bytes": s.wire_bytes,
                           "transfer_s": round(s.transfer_s, 9),
                           "admitted_tick": s.admitted_tick,
                           "finished_tick": s.finished_tick}
           for s in done}
    keys = ("decode_ticks", "decoded_slot_ticks", "mixed_mode_ticks",
            "wire_bytes", "decode_wire_bytes", "prefill_calls",
            "prefill_tokens", "prefill_padded_tokens", "mode_counts",
            "mode_switches", "mode_escalations", "requests_finished",
            "peak_pages_in_use", "requests_parked", "deadline_misses",
            "mode_policy")
    return per, {k: st[k] for k in keys}


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_flat(checkpoint._flatten(jp), device="cpu")


# five pages: requests park at the queue head until retirements free pages
ENGINE_KW = dict(n_slots=3, cache_len=32, page_len=8, n_pages=5)


@pytest.fixture(scope="module", params=[
    (True, "pertick"), (False, "pertick"), (False, "adaptive")],
    ids=["host_loop", "device_window", "adaptive_controller"])
def runs(request, weights):
    """One run of each package's engine: the orchestrator's per-tick loop
    on both loops, and the adaptive ``ModeController`` on the window."""
    host_loop, policy = request.param
    jcfg, tcfg = _cfgs()
    jp, tp = weights
    jorch = _orch(jcfg, JB, JProfile, JReq, JOrch)
    torch_orch = _orch(tcfg, TB, TProfile, TReq, TOrch)
    if policy == "adaptive":
        jkw = {"controller": JController(jorch, JCtlConfig(dwell_ticks=2))}
        tkw = {"controller": TController(torch_orch,
                                         TCtlConfig(dwell_ticks=2))}
    else:
        jkw, tkw = {"orchestrator": jorch}, {"orchestrator": torch_orch}
    jeng = JEngine(jp, jcfg, host_loop=host_loop, **jkw, **ENGINE_KW)
    jdone = jeng.run(_requests(jcfg, j_fleet, JChannelConfig, JRequest))
    jeng.close()
    teng = TEngine(tp, tcfg, host_loop=host_loop, **tkw, **ENGINE_KW)
    tdone = teng.run(_requests(tcfg, t_fleet, TChannelConfig, TRequest))
    assert teng.pool.n_free == teng.pool.n_slots
    assert teng.pool.pages_in_use == 0
    return _summary(jeng, jdone), _summary(teng, tdone)


def test_engine_modes_and_wire_bytes_match(runs):
    (jper, jst), (tper, tst) = runs
    assert set(tper) == set(jper) and len(tper) == N_REQ
    for rid in jper:
        for k in ("mode_trace", "mode_counts", "wire_bytes", "transfer_s",
                  "admitted_tick", "finished_tick"):
            assert tper[rid][k] == jper[rid][k], (rid, k)
    assert tst == jst
    # the workload really mixes modes and parks on the small arena
    assert len(tst["mode_counts"]) > 1 and tst["mixed_mode_ticks"] > 0
    assert tst["requests_parked"] > 0


def test_engine_tokens_match(runs):
    (jper, _), (tper, _) = runs
    for rid in jper:
        assert tper[rid]["tokens"] == jper[rid]["tokens"], rid


def test_port_imports_no_jax():
    """Importing every module of the port, and ``chip_smoke.py``, loads
    neither ``jax`` nor any module of the JAX package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro"
             or n.startswith("repro."))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_serve_refuses_cuda_without_a_card(monkeypatch):
    """The entry point defaults to CUDA and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen2.5-3b", "--reduced", "--requests", "1",
                    "--gen", "2"])


def test_serve_cpu_runs_reduced():
    out = serve.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                      "--engine", "continuous", "--requests", "3",
                      "--prompt-len", "5", "--gen", "4", "--n-slots", "1"])
    assert out["requests_finished"] == 3
    assert all(len(t) == 4 for t in out["tokens"].values())


def test_profile_summary_counts_as_the_event_tree():
    """``serve.profile_summary`` reads the profiler's raw events: on a CPU
    trace of a reduced continuous run it counts the casts
    (``aten::_to_copy``) that ``key_averages`` counts, and no device
    work."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import split as TSP
    args = serve.parser().parse_args(
        ["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu", "--engine",
         "continuous", "--requests", "2", "--prompt-len", "5", "--gen", "3",
         "--n-slots", "1"])
    cfg = t_reduced("qwen2.5-3b")
    params = TSP.init_split_params(torch.Generator().manual_seed(0), cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve.run_continuous(args, cfg, params)
    got = serve.profile_summary(prof, 2.0)
    casts = [e for e in prof.key_averages() if e.key == "aten::_to_copy"]
    assert got["to_copy"]["calls"] == sum(e.count for e in casts) > 0
    assert got["kernel_launches"] == 0 and got["device_busy_s"] == 0.0
    assert got["device_idle_share"] == 1.0 and got["top_kernels"] == []
