"""The serving engines' decode steps as graphs (``serving/graphs.py``): the
continuous engine's window of K ticks and the sync engine's token step,
each run over static buffers, captured on the card and uncaptured here.

On the CPU a graph cannot be captured, so two runs stand in for it: the
engines as they run here (the body at every use), and the same engines
with every key "captured" at its first use into a stand-in whose replay
runs the body stored then (``_Replayed``). A body that read anything but
its static buffers (a window's own mode tensor, a fresh block table, an
int position) would replay stale inputs and decode other tokens.

(a) the static buffers keep their addresses across windows with
admission, retirement, parking, a table-width change and an injected
session, on the paged pool (qwen2.5-3b) and the dense pool
(recurrentgemma-2b); (b) the device loop's tokens equal the host loop's
(``host_loop=True``) bit for bit, and its ``device_tel`` the host loop's
accounting, on qwen2.5-3b, recurrentgemma-2b, xlstm-125m, musicgen-large
(``[K, 1]`` tokens a slot) and a bank-free engine, telemetry on in one
case; (c) a window's tokens, read after the next window ran, are still
its own with the static output poisoned between the two; (d) the sync
engine's ``decode_tokens`` equals the per-mode eager steps at an int
position (the loop before the graphs) on the sync reference cases, and
across a ``reset``; (e) replays add the launches counted at capture, and
the capture's own calls count nothing; (f) the profile summary finds each
replay's kernels by its graph launch. Reduced float32 configs, the weights
drawn from a seed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core import split as SP
from repro_torch.core.channel import ChannelConfig, channel_fleet
from repro_torch.kernels import ops
from repro_torch.kernels.boundary_mixed import decode_tail_grouped
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.launch.serve import build_orchestrator
from repro_torch.models import transformer as T
from repro_torch.serving import (ContinuousBatchingEngine, Request,
                                 ServingEngine, Telemetry,
                                 default_orchestrator, extract_session,
                                 inject_session)
from repro_torch.serving.engine import make_serve_step
from repro_torch.serving.graphs import StepGraphs

N_REQ = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Reduced shapes: one intra-op thread is enough, and the test workers
    beside this one keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Replayed:
    """A captured graph's stand-in on the CPU: its replay runs the body
    stored at capture (the work a graph would launch)."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture(params=["uncaptured", "replayed"])
def graphs(request, monkeypatch):
    """The engines as they run on the CPU, or with every key captured into
    a ``_Replayed`` at its first use."""
    if request.param == "replayed":
        init = StepGraphs.__init__

        def capturing(self, device):
            init(self, device)
            self.capturing = True

        monkeypatch.setattr(StepGraphs, "__init__", capturing)
        monkeypatch.setattr(StepGraphs, "_record",
                            lambda self, body: _Replayed(body))
    return request.param


_PARAMS = {}


def _model(arch, bank=True):
    if arch not in _PARAMS:
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        _PARAMS[arch] = (cfg, SP.init_split_params(
            torch.Generator().manual_seed(0), cfg))
    cfg, params = _PARAMS[arch]
    if not bank:
        params = {k: v for k, v in params.items() if k != "bneck_modes"}
    return cfg, params


def _requests(cfg, n=N_REQ, seed=3, gen=(3, 9)):
    """Mixed modes (a slow, varying uplink), ragged prompts and budgets,
    staggered arrivals."""
    chans = channel_fleet(n, ChannelConfig(mean_mbps=0.5, std_mbps=0.4,
                                           blockage_prob=0.08,
                                           recovery_prob=0.15),
                          seed=11, mean_spread=0.95)
    rng = np.random.default_rng(seed)
    shape = (cfg.n_codebooks,) if T.multi_codebook(cfg) else ()
    return [Request(rid=i, prompt=rng.integers(
                1, cfg.vocab_size, size=shape + (int(rng.integers(4, 9)),)
            ).astype(np.int32),
            max_new_tokens=int(rng.integers(*gen)), channel=chans[i],
            arrival_tick=i // 2) for i in range(n)]


def _engine(cfg, params, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("cache_len", 32)
    return ContinuousBatchingEngine(params, cfg,
                                    orchestrator=default_orchestrator(cfg),
                                    **kw)


def _tokens(done):
    return {s.request.rid: list(s.tokens) for s in done}


def _addresses(eng):
    """The window's static buffers (every block-table bucket seen) and the
    pool's state leaves, by address."""
    out = {"cur_tokens": eng.cur_tokens.data_ptr(),
           "positions": eng._positions.data_ptr(),
           "modes": eng._modes_buf.data_ptr(),
           "toks_out": eng._toks_out.data_ptr()}
    out.update({f"table{w}": t.data_ptr() for w, t in eng._tables.items()})
    out.update({f"state{i}": a.data_ptr()
                for i, a in enumerate(T.tree_leaves(eng.pool.states))})
    return out


@pytest.mark.parametrize("arch,paged", [("qwen2.5-3b", True),
                                        ("recurrentgemma-2b", False)])
def test_static_buffers_keep_their_addresses(arch, paged, graphs):
    """(a) Two engines step side by side; a live session moves from the
    first into the second mid-run; every buffer keeps the address it had
    when first seen, and the run saw admissions, retirements, (paged) a
    parked request and two table widths."""
    cfg, params = _model(arch)
    kw = dict(page_len=4, n_pages=8, max_window=2) if paged else {}
    engs = [_engine(cfg, params, **kw), _engine(cfg, params, **kw)]
    assert engs[0].paged == paged
    for e in engs:
        for r in _requests(cfg, gen=(6, 14)):
            e.submit(r)
    seen = [{}, {}]
    snap, moved = None, False
    widths = set()
    for tick in range(200):
        busy = [e.step() for e in engs]
        for e, s in zip(engs, seen):
            for k, a in _addresses(e).items():
                assert s.setdefault(k, a) == a, (tick, k)
            if paged:
                widths.add(e.pool.table_width())
        if snap is None and tick >= 2 and engs[0].active:
            rid = next(iter(engs[0].active.values())).request.rid
            snap = extract_session(engs[0], rid)
        if snap is not None and not moved:
            moved = inject_session(engs[1], snap)
        if not any(busy):
            break
    assert moved
    for e in engs:
        e.close()
        assert e.decode_ticks > 0
    assert engs[0].stats()["requests_finished"] == N_REQ - 1
    assert engs[1].stats()["requests_finished"] == N_REQ + 1
    if paged:
        assert engs[0].requests_parked + engs[1].requests_parked > 0
        assert len(widths) >= 2 and len(engs[1]._tables) >= 2


CASES = [("qwen2.5-3b", True, False), ("recurrentgemma-2b", True, True),
         ("xlstm-125m", True, False), ("musicgen-large", True, False),
         ("qwen2.5-3b", False, False)]


@pytest.mark.parametrize("arch,bank,tel", CASES,
                         ids=["qwen2.5-3b", "recurrentgemma-2b-telemetry",
                              "xlstm-125m", "musicgen-large",
                              "qwen2.5-3b-bank-free"])
def test_device_loop_equals_host_loop(arch, bank, tel, graphs):
    """(b) The same requests on the host loop and on the device loop: the
    same tokens and lifecycle; with telemetry, the folded window blocks
    equal the host loop's wire bytes, decoded tokens and mode ticks."""
    cfg, params = _model(arch, bank)
    runs = {}
    for host_loop in (True, False):
        eng = _engine(cfg, params, host_loop=host_loop,
                      telemetry=Telemetry() if tel else None)
        done = eng.run(_requests(cfg))
        runs[host_loop] = (eng, _tokens(done), eng.stats())
    (_, want, hst), (dev, got, dst) = runs[True], runs[False]
    assert got == want and len(got) == N_REQ
    for k in ("decode_tokens", "decode_wire_bytes", "mode_counts",
              "requests_finished", "mode_switches"):
        assert dst[k] == hst[k], k
    if bank and arch != "musicgen-large":
        assert len(hst["mode_counts"]) >= 2
    if tel:
        ticks = np.zeros_like(dev.device_tel["mode_ticks"])
        for m, n in hst["mode_counts"].items():
            ticks[m] = n
        assert dev.device_tel["wire_bytes"] == hst["decode_wire_bytes"]
        assert dev.device_tel["slot_ticks"] == hst["decode_tokens"]
        assert np.array_equal(dev.device_tel["mode_ticks"], ticks)
    if graphs == "replayed":
        assert dev.graphs.replays > 0


def test_lagged_read_keeps_its_window(graphs):
    """(c) Poison the static token output after each dispatch: every
    window's tokens, read one window later, are still its own."""
    cfg, params = _model("qwen2.5-3b")
    want = _tokens(_engine(cfg, params, host_loop=True).run(_requests(cfg)))
    eng = _engine(cfg, params)
    for r in _requests(cfg):
        eng.submit(r)
    windows = 0
    while eng.step():
        eng._toks_out.fill_(-7)
        windows += 1
    eng.close()
    assert windows > 2
    assert _tokens(eng.finished) == want


def _capacities():
    """A link (bytes/s) that drops below mode 0's rate and recovers, so the
    orchestrator leaves mode 0 and comes back."""
    caps = iter([1e8] * 2 + [1e3] * 6 + [1e8] * 20)
    return lambda: next(caps)


def _eager_tokens(eng, first, n, caps):
    """The sync engine's decode loop before the graphs: one eager step a
    token on the orchestrator's mode, at an int position."""
    tok = torch.as_tensor(first)
    out, modes = [], {}
    for _ in range(n):
        eng.orch.observe_capacity(caps())
        mode = eng.orch.choose_mode()
        modes[mode] = modes.get(mode, 0) + 1
        tok, eng.states = make_serve_step(eng.run_cfg, mode=mode,
                                          return_tokens=True)(
            eng.params, tok, eng.states, eng.pos)
        eng.pos += 1
        out.append(tok)
    return torch.cat(out, dim=-1).numpy(), modes


_batch_positions = T.batch_positions


def _device_positions_only(cur_pos, batch, device):
    assert torch.is_tensor(cur_pos) and cur_pos.shape == (batch,)
    return _batch_positions(cur_pos, batch, device)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "xlstm-125m"])
def test_sync_decode_tokens_equal_eager_steps(arch, graphs):
    """(d) ``decode_tokens`` (graph steps over the device positions)
    against the eager per-mode steps at an int position, from the same
    prefill and orchestrator: the same tokens and modes, twice on one
    engine (``reset`` between, keeping the state's addresses)."""
    cfg, params = _model(arch)
    prompt = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 8)).astype(np.int32)

    def fresh():
        return ServingEngine(params, cfg, cache_len=32, batch=2,
                             orchestrator=build_orchestrator(cfg, 2,
                                                             4.01e-3))

    ref = fresh()
    first = torch.argmax(ref.prefill(prompt), -1).to(torch.int32)
    want, want_modes = _eager_tokens(ref, first, 12, _capacities())
    assert len(want_modes) >= 2
    eng = fresh()
    addrs = [a.data_ptr() for a in T.tree_leaves(eng.states)]
    for _ in range(2):
        eng.orch = build_orchestrator(cfg, 2, 4.01e-3)
        eng.stats.mode_counts.clear()
        first = torch.argmax(eng.prefill(prompt), -1).to(torch.int32)
        with pytest.MonkeyPatch.context() as mp:
            # a graph would bake an int position in: the step's must be
            # the device tensor
            mp.setattr(T, "batch_positions", _device_positions_only)
            got = eng.decode_tokens(first, 12,
                                    capacity_bps_fn=_capacities())
        assert np.array_equal(got, want) and got.dtype == np.int32
        assert eng.stats.mode_counts == want_modes and eng.pos == 8 + 12
        assert [a.data_ptr() for a in T.tree_leaves(eng.states)] == addrs
        eng.reset()
    if graphs == "replayed":
        assert sorted(eng.graphs.keys) == sorted(want_modes)
        assert eng.graphs.replays == 2 * 12 - len(want_modes)


def test_replays_add_the_captured_launches(monkeypatch):
    """(e) A body that launches 3 tails and 2 paged attentions: its first
    use runs it (5 launches counted), its capture counts nothing, each
    replay adds the captured 3 and 2; the tallies count each kind."""
    monkeypatch.setattr(decode_tail_grouped, "launches", 0)
    monkeypatch.setattr(paged_attention, "launches", 0)
    runs = []

    def body():
        runs.append(1)
        decode_tail_grouped.launches += 3
        paged_attention.launches += 2

    g = StepGraphs("cpu")
    g.capturing = True
    # the capture calls the body (its counts are taken back); the replay
    # runs no Python
    monkeypatch.setattr(g, "_record",
                        lambda b: (b(), _Replayed(lambda: None))[1])
    totals = dict(StepGraphs.totals)
    g.run("k", body, steps=4)
    assert len(runs) == 2                      # the warm-up and the capture
    assert ops.launch_counts()["decode_tail_grouped"] == 3
    assert ops.launch_counts()["paged_attention"] == 2
    assert g.keys == ["k"] and g.replays == 0
    for _ in range(3):
        g.run("k", body, steps=4)
    assert len(runs) == 2                      # replays run no Python
    assert decode_tail_grouped.launches == 3 + 3 * 3
    assert paged_attention.launches == 2 + 3 * 2
    assert g.replays == 3
    diff = {k: StepGraphs.totals[k] - totals[k] for k in totals}
    assert diff == {"captures": 1, "replays": 3, "eager_steps": 4,
                    "captured_steps": 4, "replayed_steps": 12}


class _Event:
    """A raw profiler event as ``profile_summary`` reads it."""

    def __init__(self, name, corr=0, linked=0, start=0, end=0, thread=1,
                 device=False):
        self._v = dict(name=name, corr=corr, linked=linked, start=start,
                       end=end, thread=thread, device=device)

    def name(self):
        return self._v["name"]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v["device"] else DeviceType.CPU

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]

    def start_thread_id(self):
        return self._v["thread"]

    def start_ns(self):
        return self._v["start"]

    def end_ns(self):
        return self._v["end"]

    def duration_ns(self):
        return self._v["end"] - self._v["start"]


def _trace(events):
    from types import SimpleNamespace
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_profile_summary_finds_the_replays():
    """(f) ``profile_summary`` gives a kernel to the graph replay whose
    ``cudaGraphLaunch`` shares its correlation id: two replays' kernels,
    busy time and span, apart from an eager op's and a cast's kernels."""
    from repro_torch.launch.serve import profile_summary
    kern = dict(device=True)
    events = [
        _Event("aten::mm", corr=1, start=0, end=10),
        _Event("cudaLaunchKernel", corr=90, start=2, end=3),
        _Event("gemm", corr=90, linked=90, start=100, end=105, **kern),
        _Event("cudaGraphLaunch", corr=91, start=21, end=25),
        _Event("tail", corr=91, linked=7, start=200, end=210, **kern),
        _Event("attn", corr=91, start=215, end=220, **kern),
        _Event("cudaGraphLaunch", corr=92, start=41, end=45),
        _Event("tail", corr=92, linked=7, start=300, end=304, **kern),
        _Event("aten::_to_copy", corr=4, start=60, end=70),
        _Event("aten::copy_", corr=5, start=61, end=69),
        _Event("cudaLaunchKernel", corr=93, start=62, end=63),
        _Event("cast", corr=93, linked=93, start=400, end=407, **kern),
    ]
    got = profile_summary(_trace(events), 1e-6)
    assert got["kernel_launches"] == 5
    assert got["device_busy_s"] == pytest.approx(31e-9)
    assert got["launch_calls"] == {"cudaLaunchKernel": 2,
                                   "cudaGraphLaunch": 2}
    assert got["graph_replays"] == {"replays": 2, "kernels": 3,
                                    "busy_s": 19e-9, "span_s": 24e-9}
    assert got["to_copy"] == {"calls": 1, "device_ms": 7e-6}
    assert [k["name"] for k in got["top_kernels"]] == [
        "tail", "cast", "gemm", "attn"]
