"""The continuous engine's bank-free steps and its unfused window in the
port.

Params without a bottleneck bank run the reference's "mono" steps
(``T.decode_step`` / ``T.prefill`` of the unsplit model, the boundary
crossing raw, every tick accounted on mode 0): held against the JAX
package's bank-free engine on the three decode-state families (paged
attention, RG-LRU with the rolling window, xLSTM), reduced f32 with
converted weights: per-request tokens, modes, wire bytes and the
tick-exact lifecycle must be equal. ``fused_tail=False`` (the logits +
argmax window body, the reference's oracle in
``tests/test_device_loop.py``) must decode exactly the fused window's
streams, with and without the bank, and so must the host loop. A mode
controller without a bank raises ``ValueError``, as the reference's.
"""
import dataclasses

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
from repro.models import sharding as j_sharding
from repro.serving import batcher as JBatcher
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import Request as JRequest
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core import split as TSP
from repro_torch.core.channel import ChannelConfig as TChannelConfig
from repro_torch.core.channel import channel_fleet as t_fleet
from repro_torch.core.orchestrator import (AppRequirement as TReq,
                                           ModeProfile as TProfile,
                                           Orchestrator as TOrch)
from repro_torch.serving import ContinuousBatchingEngine as TEngine
from repro_torch.serving import ModeController, Request

ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m")
N_REQ = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced shapes: one intra-op thread is enough, and the test workers
    beside this one keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _reference_block_tables_copied():
    """The reference's paged pool hands rows of its numpy block table to
    work that runs later, which races under CPU load (ROADMAP Queue 3):
    give the window a copy, as ``tests/test_torch_migration.py`` does."""
    def block_table(self):
        return j_sharding.shard_batch(jax.numpy.asarray(
            self.block_np[:, :self.table_width()].copy()), self.mesh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBatcher.PagedPool, "block_table", block_table)
        yield


def _no_bank(params):
    return {k: v for k, v in params.items() if k != "bneck_modes"}


def _requests(cfg, fleet, chan_cfg, request_cls):
    chans = fleet(N_REQ, chan_cfg(mean_mbps=0.5, std_mbps=0.4,
                                  blockage_prob=0.08, recovery_prob=0.15),
                  seed=11, mean_spread=0.95)
    rng = np.random.default_rng(3)
    return [request_cls(rid=i, prompt=rng.integers(
                1, cfg.vocab_size, size=int(rng.integers(4, 9))).astype(
                    np.int32),
            max_new_tokens=int(rng.integers(2, 8)), channel=chans[i],
            arrival_tick=i // 2) for i in range(N_REQ)]


def _run(eng_cls, cfg, params, bn, fleet, chan_cfg, request_cls, profile,
         req, orch, **kw):
    orch = orch([profile(m, bn.mode_payload_bytes(cfg, 1, 1, m), float(m))
                 for m in range(cfg.split.n_modes)],
                req(latency_budget_s=0.006), ema=0.5, hysteresis=1.0)
    eng = eng_cls(params, cfg, orchestrator=orch, n_slots=3, cache_len=32,
                  **kw)
    done = eng.run(_requests(cfg, fleet, chan_cfg, request_cls))
    st = eng.stats()
    per = {s.request.rid: (list(s.tokens), [tuple(t) for t in s.mode_trace],
                           s.wire_bytes, s.admitted_tick, s.finished_tick)
           for s in done}
    keys = ("paged", "decode_ticks", "mixed_mode_ticks", "wire_bytes",
            "prefill_calls", "mode_counts", "requests_finished",
            "decode_wire_bytes")
    return per, {k: st[k] for k in keys}


def _torch_run(cfg, params, **kw):
    return _run(TEngine, cfg, params, TB, t_fleet, TChannelConfig, Request,
                TProfile, TReq, TOrch, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_bank_free_engine_matches_reference(arch):
    """The bank-free engine of both packages on the same requests and
    channels: every tick on mode 0 (the raw boundary's bytes), the same
    tokens and lifecycle."""
    jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
    jp = _no_bank(JSP.init_split_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    assert "bneck_modes" not in tp
    want = _run(JEngine, jcfg, jp, JB, j_fleet, JChannelConfig, JRequest,
                JProfile, JReq, JOrch)
    got = _torch_run(tcfg, tp)
    assert got == want
    assert set(got[1]["mode_counts"]) == {0}
    assert got[1]["requests_finished"] == N_REQ


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "bank-free"])
@pytest.mark.parametrize("arch", [*ARCHS, "musicgen-large"])
def test_unfused_window_token_identical(arch, bank):
    """``fused_tail=False`` (logits + argmax each window tick) decodes the
    fused window's streams exactly, as does the host loop: tokens, modes,
    wire bytes, lifecycle and counters."""
    cfg = t_reduced(arch)
    params = TSP.init_split_params(torch.Generator().manual_seed(0), cfg)
    if not bank:
        params = _no_bank(params)
    fused = _torch_run(cfg, params)
    unfused = _torch_run(cfg, params, fused_tail=False)
    host = _torch_run(cfg, params, host_loop=True)
    assert unfused == fused and host == fused
    assert fused[1]["requests_finished"] == N_REQ
    assert (len(fused[1]["mode_counts"]) > 1) == bank


def test_controller_without_bank_raises():
    cfg = t_reduced("qwen2.5-3b")
    params = _no_bank(TSP.init_split_params(torch.Generator().manual_seed(0),
                                            cfg))
    orch = TOrch([TProfile(m, TB.mode_payload_bytes(cfg, 1, 1, m), float(m))
                  for m in range(cfg.split.n_modes)],
                 TReq(latency_budget_s=0.006))
    with pytest.raises(ValueError, match="bank"):
        TEngine(params, cfg, controller=ModeController(orch))
