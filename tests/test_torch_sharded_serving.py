"""The port's serving mesh (``repro_torch.models.sharding``) on gloo ranks.

The counterparts of the reference's ``tests/test_sharded_serving.py`` on
reduced float32 qwen2.5-3b, recurrentgemma-2b and xlstm-125m, with weights
converted
from the JAX package's ``init_split_params``. Each rank is a process of a
gloo group on the CPU; the ranks of one world size are started once per
module and run every scenario of that size (``_rank``), importing torch
and the port only. The parent runs the one-device engines: the JAX
reference's and the port's.

- dp is bit-identical to ``mesh=None``: at dp 2 and 4, on the host and the
  device loop, the paged and the dense pool, tokens, wire bytes, mode
  counts and finished ticks equal the port's one-device engine and the
  JAX reference's; also where dp does not divide the slots (dp 4 over 6:
  the axis replicates).
- mp keeps the schedule and the accounting: at (dp, mp) = (1, 2) and (2,
  2) every request finishes on the same tick with the same wire bytes and
  modes; the unfused engine's float32 logits of each live row and tick
  agree with the one-device engine's within ``MP_LOGIT_ATOL``, decided
  before the run from the arithmetic (two partial sums added in float32 at
  ``wo`` and ``w_down``, a few ulps of logits of order 1), and tokens are
  equal except where the one-device top-two gap is within it. The same
  holds of the RG-LRU and xLSTM mixers over mp 2 (each rank its channels
  or heads, the recurrent state split with them), whose one-device
  tokens are the JAX engine's; their sync engine at mp 2 decodes the
  one-device tokens, and a migration snapshot at mp 2 has the one-device
  snapshot's layout and bytes count, every leaf gathered whole (its values
  within ``MP_LOGIT_ATOL`` plus ``MP_STATE_RTOL`` of one device's: mp
  reassociates the row-split sums).
- Migration is mesh-blind: a live migration between two dp-2 replicas (4
  ranks) resumes the unmigrated stream; a snapshot from a dp-4 engine
  equals the one-device snapshot byte for byte.
- Pool placement: each rank's slots (it decodes every slot's row, in its
  place, as one device does), the paged pool's per-shard free lists and
  padded arenas.
- Validation needs no ranks: axes under 1, too few ranks, an
  oversubscribed cluster. On ranks, MoE, RG-LRU and xLSTM layers pass the
  mesh's check on both engines, each block kind split where it divides.

The JAX package is imported inside the fixtures, not at the top: the
ranks import this module to find their scenarios and must load no
``jax``.
"""
import dataclasses
import datetime
import importlib
import socket
import sys
import traceback
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core.channel import MobilityChannel
from repro_torch.kernels import ops
from repro_torch.models import sharding
from repro_torch.models.sharding import serving_mesh
from repro_torch.serving import (ContinuousBatchingEngine, EdgeCluster,
                                 PagedPool, Request, ServingEngine,
                                 SlotPool, default_orchestrator,
                                 extract_session)

ARCHS = ["qwen2.5-3b", "recurrentgemma-2b"]
QWEN, RG = ARCHS
XL = "xlstm-125m"
MIXERS = (RG, XL)
#: |logit| difference allowed between an mp run and one device (float32)
MP_LOGIT_ATOL = 1e-4
#: relative difference allowed between an mp snapshot's state and one
#: device's (float32, beside ``MP_LOGIT_ATOL``)
MP_STATE_RTOL = 1e-5
#: seconds a rank waits in a collective before its group gives up
RANK_TIMEOUT = 120


def _cfg(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _reqs(cfg, n=6, gen=12, seed=0, request_cls=Request):
    rng = np.random.default_rng(seed)
    return [request_cls(rid=i,
                        prompt=rng.integers(1, cfg.vocab_size,
                                            (5 + i % 3,)).astype(np.int32),
                        max_new_tokens=gen)
            for i in range(n)]


def _summary(done):
    return {s.request.rid: (tuple(int(t) for t in s.tokens), s.wire_bytes,
                            tuple(sorted(s.mode_counts.items())),
                            s.finished_tick) for s in done}


def _recording(eng):
    """Record each unfused step's live slots and the logits rows of the
    slots ``eng``'s rank holds."""
    tape = []
    decode = eng._decode
    lo, hi = eng.pool.rows.lo, eng.pool.rows.hi

    def rec(tok, positions, modes, bt, return_tokens):
        out = decode(tok, positions, modes, bt, return_tokens)
        if not return_tokens:
            tape.append((sorted(eng.active),
                         out[lo:hi, 0].detach().numpy().copy()))
        return out

    eng._decode = rec
    return tape


def _run(cfg, params, mesh, *, host_loop=False, paged=None, n=6, n_slots=4,
         fused_tail=True, engine_cls=ContinuousBatchingEngine,
         request_cls=Request, orchestrator=default_orchestrator):
    eng = engine_cls(params, cfg, n_slots=n_slots, cache_len=48,
                     orchestrator=orchestrator(cfg), host_loop=host_loop,
                     paged=paged, fused_tail=fused_tail,
                     **({} if mesh is None else {"mesh": mesh}))
    tape = None if fused_tail else _recording(eng)
    with eng:
        done = eng.run(_reqs(cfg, n=n, request_cls=request_cls))
    out = {"sessions": _summary(done),
           "admitted": {s.request.rid: s.admitted_tick for s in done},
           "slots": {s.request.rid: s.slot for s in done},
           "rows": (eng.pool.rows.lo, eng.pool.rows.hi)}
    if tape is not None:
        out["tape"] = tape
    return out


def _mobility(cross_at, *, n_ticks=64, cap=2e6):
    cells = [0] * cross_at + [1] * n_ticks
    return MobilityChannel(cells, [cap, cap], detach_factor=1.0)


def _mobile_reqs(cfg):
    rng = np.random.default_rng(3)
    return [Request(rid=0, prompt=rng.integers(1, cfg.vocab_size,
                                                (4,)).astype(np.int32),
                    max_new_tokens=12, channel=_mobility(5))]


def _snapshot_wire(cfg, params, mesh, paged):
    """The raw snapshot of the session in slot 2 of a 4-slot host-loop
    engine after 5 ticks (on dp 4: held by rank 2)."""
    eng = ContinuousBatchingEngine(
        params, cfg, n_slots=4, cache_len=48,
        orchestrator=default_orchestrator(cfg), host_loop=True, paged=paged,
        **({} if mesh is None else {"mesh": mesh}))
    with eng:
        rng = np.random.default_rng(9)
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=rng.integers(
                1, cfg.vocab_size, (4 + rid,)).astype(np.int32),
                max_new_tokens=20))
        for _ in range(5):
            eng.step()
        slot = next(s for s, sess in eng.active.items()
                    if sess.request.rid == 2)
        snap = extract_session(eng, rid=2)
    return {"slot": slot, "position": snap.position,
            "cur_token": snap.cur_token, "nbytes": snap.nbytes,
            "wire": [(e[0], e[1]) for e in snap.wire]}


# ---------------------------------------------------------------------------
# scenarios: run on every rank of a world, inside the group
# ---------------------------------------------------------------------------

def _sc_run(models, arch, dp, mp=1, **kw):
    cfg, params = models[arch]
    return _run(cfg, params, serving_mesh(dp, mp, device="cpu"), **kw)


def _sc_sync(models, dp):
    cfg, params = models[QWEN]
    mesh = serving_mesh(dp, 1, device="cpu")
    return _sync(cfg, params, mesh)


def _sync(cfg, params, mesh):
    """The sync engine: a 4-row prefill, 6 orchestrator-mode tokens on
    the fused tail and 4 on mode 1 through the logits chain."""
    eng = ServingEngine(params, cfg, cache_len=48, batch=4,
                        orchestrator=default_orchestrator(cfg),
                        **({} if mesh is None else {"mesh": mesh}))
    rng = np.random.default_rng(5)
    logits = eng.prefill(rng.integers(1, cfg.vocab_size, (4, 7)).astype(
        np.int64))
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    toks = eng.decode_tokens(first, 6)
    more, wire = eng.decode_static(torch.as_tensor(toks[:, -1:]), 4, 1)
    return {"tokens": toks.tolist(), "more": more.tolist(), "wire": wire,
            "stats": (eng.stats.tokens, eng.stats.wire_bytes,
                      dict(eng.stats.mode_counts))}


def _sc_migrate(models, arch):
    cfg, params = models[arch]
    cluster = EdgeCluster(params, cfg, n_replicas=2, n_slots=2, cache_len=48,
                          placement="best-channel", handover="migrate",
                          dp=2, devices="cpu")
    ranks = [e.mesh.ranks for e in cluster.replicas]
    got = cluster.run(_mobile_reqs(cfg))
    st = cluster.stats()
    cluster.close()
    return {"ranks": ranks, "migrations": st["migrations"],
            "sessions": _summary(got)}


def _sc_snapshot(models, dp):
    cfg, params = models[QWEN]
    mesh = serving_mesh(dp, 1, device="cpu")
    return {paged: _snapshot_wire(cfg, params, mesh, paged)
            for paged in (True, False)}


def _sc_pools(models, dp):
    cfg, _ = models[QWEN]
    mesh = serving_mesh(dp, 1, device="cpu")
    pool = SlotPool(cfg, n_slots=4, cache_len=16, mesh=mesh, device="cpu")
    rows = pool.read_rows([2, 0])
    paged = PagedPool(cfg, n_slots=4, cache_len=32, mesh=mesh, device="cpu")
    tight = PagedPool(cfg, n_slots=4, cache_len=32, n_pages=7, mesh=mesh,
                      device="cpu")
    slot3 = tight.shard_pages[mesh.shard_of(3, 4)]
    exhausted = False
    try:
        tight.alloc_pages(3, (slot3 + 1) * tight.page_len)
    except RuntimeError:
        exhausted = True
    return {
        "slot_rows": (pool.rows.lo, pool.rows.hi),
        "slot_state_rows": [tuple(a.shape) for _, a in
                            sharding._path_leaves(pool.states)],
        "read_rows": [(p, tuple(a.shape)) for p, a in
                      sharding._path_leaves(rows)],
        "arena": next(sharding._path_leaves(paged.states))[1].shape[1],
        "n_pages": paged.n_pages, "free": paged.free_page_count,
        "shard_pages": paged.shard_pages,
        "tight_arena": tight.arena_pages,
        "tight_shard_pages": tight.shard_pages,
        "tight_free": tight.free_page_count,
        "slot3_pages": slot3, "exhausted": exhausted,
    }


def _sc_shard_params(models, mp):
    cfg, params = models[QWEN]
    mesh = serving_mesh(1, mp, device="cpu")
    local = sharding.shard_params(params, mesh, cfg=cfg)
    return {"coords": mesh.coords,
            "flat": {p: a.numpy().copy()
                     for p, a in sharding._path_leaves(local)},
            "local_cfg": (mesh.local_cfg(cfg).n_heads,
                          mesh.local_cfg(cfg).n_kv_heads,
                          mesh.local_cfg(cfg).head_dim,
                          mesh.local_cfg(cfg).d_ff)}


def _sc_mp_raises(models, mp):
    """MoE, RG-LRU and xLSTM layers pass the mesh's check on both engines:
    each engine builds on the rank's slices; returns the block kinds that
    split and the rank's config's head count and RG-LRU width."""
    from repro_torch.core.split import init_split_params
    mesh = serving_mesh(1, mp, device="cpu")
    out = {}
    for arch in ("mixtral-8x7b", "recurrentgemma-2b", "xlstm-125m"):
        cfg = get_reduced(arch)
        params = init_split_params(torch.Generator().manual_seed(0), cfg)
        for cls in (ContinuousBatchingEngine, ServingEngine):
            eng = cls(params, cfg, cache_len=16, mesh=mesh)
            out[(arch, cls.__name__)] = (mesh.check_model(cfg),
                                         eng.run_cfg.n_heads,
                                         eng.run_cfg.d_rnn)
    return out


def _sc_sync_mp(models, arch, mp):
    cfg, params = models[arch]
    return _sync(cfg, params, serving_mesh(1, mp, device="cpu"))


def _snapshot_state(cfg, params, mesh):
    """The dense snapshot of ``_snapshot_wire``: its layout and leaves."""
    got = _snapshot_wire(cfg, params, mesh, False)
    return {"slot": got["slot"], "position": got["position"],
            "cur_token": got["cur_token"], "nbytes": got["nbytes"],
            "wire": got["wire"]}


def _sc_snapshot_mp(models, arch, mp):
    cfg, params = models[arch]
    return _snapshot_state(cfg, params, serving_mesh(1, mp, device="cpu"))


SERVE = ["--arch", QWEN, "--reduced", "--device", "cpu", "--requests", "4",
         "--gen", "5"]
BENCH = ["--reduced", "--device", "cpu", "--loads", "8", "--requests", "2",
         "--gen", "4", "--compare-slots", "0", "--overhead-repeats", "0",
         "--prefill-prompt-len", "8", "--slot-scaling", "1,2"]


def _sc_launchers(models):
    """``launch.serve --dp 2`` and ``bench_serving --slot-scaling 1,2``
    on the ranks of the initialized group."""
    from repro_torch.benchmarks import bench_serving
    from repro_torch.launch import serve
    out = serve.main(SERVE + ["--engine", "continuous", "--dp", "2"])
    sc = bench_serving.main(BENCH)["slot_scaling"]
    return {"tokens": out["tokens"], "mesh": out["mesh"],
            "finished": out["requests_finished"], "slot_scaling": sc}


def _sc_serve_mp(models, arch):
    """``launch.serve --mp 2`` of a reduced mixer arch on the group."""
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--requests", "3", "--gen", "4", "--engine",
                      "continuous", "--mp", "2"])
    return {"tokens": out["tokens"], "mesh": out["mesh"],
            "finished": out["requests_finished"]}


SCENARIOS = {"run": _sc_run, "sync": _sc_sync, "migrate": _sc_migrate,
             "snapshot": _sc_snapshot, "pools": _sc_pools,
             "shard_params": _sc_shard_params, "mp_raises": _sc_mp_raises,
             "launchers": _sc_launchers, "sync_mp": _sc_sync_mp,
             "snapshot_mp": _sc_snapshot_mp, "serve_mp": _sc_serve_mp}

WORLD2 = (
    ("dp2 host", "run", (QWEN, 2), {"host_loop": True}),
    ("dp2 device", "run", (QWEN, 2), {}),
    ("dp2 dense", "run", (QWEN, 2), {"paged": False}),
    ("rg dp2 host", "run", (RG, 2), {"host_loop": True}),
    ("rg dp2 device", "run", (RG, 2), {}),
    ("mp2 unfused", "run", (QWEN, 1, 2), {"fused_tail": False}),
    ("sync dp2", "sync", (2,), {}),
    ("shard_params", "shard_params", (2,), {}),
    ("mp_raises", "mp_raises", (2,), {}),
    ("launchers", "launchers", (), {}),
    *((f"{a} mp2 unfused", "run", (a, 1, 2), {"fused_tail": False})
      for a in MIXERS),
    *((f"{a} mp2 sync", "sync_mp", (a, 2), {}) for a in MIXERS),
    *((f"{a} mp2 snapshot", "snapshot_mp", (a, 2), {}) for a in MIXERS),
    ("serve rg mp2", "serve_mp", (RG,), {}),
)
WORLD4 = (
    ("dp4 host", "run", (QWEN, 4), {"host_loop": True}),
    ("dp4 device", "run", (QWEN, 4), {}),
    ("dp4 paged", "run", (QWEN, 4), {"paged": True}),
    ("rg dp4 host", "run", (RG, 4), {"host_loop": True}),
    ("rg dp4 device", "run", (RG, 4), {}),
    ("dp4 over 6 slots", "run", (QWEN, 4), {"n_slots": 6}),
    ("dp2 mp2 unfused", "run", (QWEN, 2, 2), {"fused_tail": False}),
    ("migrate qwen", "migrate", (QWEN,), {}),
    ("migrate rg", "migrate", (RG,), {}),
    ("snapshot dp4", "snapshot", (4,), {}),
    ("pools dp4", "pools", (4,), {}),
)


def _rank(rank, world, port, flats, scenarios, queue):
    """One gloo rank: the port's models from the JAX weights' numpy
    leaves, every scenario in order, then its results (and the modules
    of the JAX package it loaded: none) to the parent."""
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        models = {a: (_cfg(a), params_from_flat(f, device="cpu"))
                  for a, f in flats.items()}
        out = {}
        for name, kind, args, kw in scenarios:
            out[name] = SCENARIOS[kind](models, *args, **kw)
        out["loaded"] = sorted(n for n in sys.modules
                               if n.split(".")[0] in ("jax", "repro"))
        queue.put((rank, out))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn(world, flats, scenarios):
    ctx = tmp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, flats,
                                             scenarios, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=4 * RANK_TIMEOUT)
                       for _ in range(world))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    for r, res in sorted(results.items()):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return results


# ---------------------------------------------------------------------------
# fixtures: weights, the one-device runs, the worlds
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (imported here, not at the top)."""
    names = {"jax": "jax", "JSP": "repro.core.split",
             "JB": "repro.serving.batcher", "JS": "repro.models.sharding",
             "serving": "repro.serving", "ckpt": "repro.training.checkpoint",
             "jcfg": "repro.configs"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture(scope="module")
def flats(ref):
    """Each arch's JAX init as the numpy leaves the port converts."""
    out = {}
    for arch in ARCHS + [XL]:
        jcfg = dataclasses.replace(ref.jcfg.get_reduced(arch),
                                   dtype="float32")
        jp = ref.JSP.init_split_params(ref.jax.random.PRNGKey(0), jcfg)
        out[arch] = {k: np.asarray(v)
                     for k, v in ref.ckpt._flatten(jp).items()}
    return out


@pytest.fixture(scope="module")
def models(flats):
    return {a: (_cfg(a), params_from_flat(f, device="cpu"))
            for a, f in flats.items()}


@pytest.fixture(scope="module")
def jax_runs(ref):
    """The JAX reference's one-device engine (``mesh=None``) on the same
    weights and requests: qwen2.5-3b (its default paged pool) and
    recurrentgemma-2b, host and device loops. The reference's paged
    device loop gets copies of its block tables (ROADMAP Queue 3, as in
    ``tests/test_torch_cluster.py``)."""
    JB, JS = ref.JB, ref.JS

    def block_table(self):
        return JS.shard_batch(ref.jax.numpy.asarray(
            self.block_np[:, :self.table_width()].copy()), self.mesh)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB.PagedPool, "block_table", block_table)
        for arch in ARCHS:
            jcfg = dataclasses.replace(ref.jcfg.get_reduced(arch),
                                       dtype="float32")
            jp = ref.JSP.init_split_params(ref.jax.random.PRNGKey(0), jcfg)
            for host_loop in (True, False):
                eng = ref.serving.ContinuousBatchingEngine(
                    jp, jcfg, n_slots=4, cache_len=48,
                    orchestrator=ref.serving.default_orchestrator(jcfg),
                    host_loop=host_loop)
                with eng:
                    done = eng.run(_reqs(jcfg,
                                         request_cls=ref.serving.Request))
                out[(arch, host_loop)] = _summary(done)
        jcfg = dataclasses.replace(ref.jcfg.get_reduced(XL), dtype="float32")
        eng = ref.serving.ContinuousBatchingEngine(
            ref.JSP.init_split_params(ref.jax.random.PRNGKey(0), jcfg), jcfg,
            n_slots=4, cache_len=48,
            orchestrator=ref.serving.default_orchestrator(jcfg))
        with eng:
            out[(XL, False)] = _summary(eng.run(_reqs(
                jcfg, request_cls=ref.serving.Request)))
    return out


@pytest.fixture(scope="module")
def one_device(models):
    """The port's one-device runs every scenario is held to."""
    out = {}
    for arch in ARCHS:
        cfg, params = models[arch]
        for host_loop in (True, False):
            out[(arch, host_loop)] = _run(cfg, params, None,
                                          host_loop=host_loop)
    cfg, params = models[QWEN]
    out["dense"] = _run(cfg, params, None, paged=False)
    out["paged"] = _run(cfg, params, None, paged=True)
    out["6 slots"] = _run(cfg, params, None, n_slots=6)
    out["unfused"] = _run(cfg, params, None, fused_tail=False)
    out["sync"] = _sync(cfg, params, None)
    out["snapshot"] = {paged: _snapshot_wire(cfg, params, None, paged)
                       for paged in (True, False)}
    for arch in ARCHS:
        cfg, params = models[arch]
        eng = ContinuousBatchingEngine(params, cfg, n_slots=2, cache_len=48,
                                       orchestrator=default_orchestrator(cfg))
        with eng:
            out[("mobile", arch)] = _summary(eng.run(_mobile_reqs(cfg)))
    for arch in MIXERS:
        cfg, params = models[arch]
        out[("unfused", arch)] = _run(cfg, params, None, fused_tail=False)
        out[("sync", arch)] = _sync(cfg, params, None)
        out[("snapshot", arch)] = _snapshot_state(cfg, params, None)
    return out


@pytest.fixture(scope="module")
def world2(flats):
    return _spawn(2, flats, WORLD2)


@pytest.fixture(scope="module")
def world4(flats):
    return _spawn(4, flats, WORLD4)


def _same_on_every_rank(world, name, key=None):
    """A scenario's result (its ``key`` entry), equal on every rank."""
    vals = [world[r][name] if key is None else world[r][name][key]
            for r in sorted(world)]
    for v in vals[1:]:
        assert v == vals[0], name
    return vals[0]


# ---------------------------------------------------------------------------
# dp: bit identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host_loop", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dp_sharded_stream_bit_identical(arch, host_loop, world2, world4,
                                         one_device, jax_runs):
    """dp 2 and 4 decode the one-device stream exactly: tokens, wire
    bytes, mode counts, finished ticks, on every rank, equal to the port's
    ``mesh=None`` engine and the JAX reference's."""
    base = one_device[(arch, host_loop)]["sessions"]
    assert base == jax_runs[(arch, host_loop)]
    loop = "host" if host_loop else "device"
    prefix = "rg " if arch == RG else ""
    for world, dp in ((world2, 2), (world4, 4)):
        name = f"{prefix}dp{dp} {loop}"
        assert _same_on_every_rank(world, name, "sessions") == base, name
        per = 4 // dp
        assert [world[r][name]["rows"] for r in sorted(world)] == [
            (r * per, (r + 1) * per) for r in range(dp)]


def test_dp_not_dividing_slots_bit_identical(world4, one_device):
    """dp 4 over 6 slots: the slot axis replicates (every rank decodes
    every slot) and the stream is still the one-device stream."""
    name = "dp4 over 6 slots"
    assert _same_on_every_rank(world4, name, "rows") == (0, 6)
    assert _same_on_every_rank(world4, name, "sessions") == \
        one_device["6 slots"]["sessions"]


def test_paged_pool_sharded_bit_identical(world2, world4, one_device):
    """The paged pool over dp (each shard its own pages) decodes the
    unsharded paged and dense engines' stream, and so does the dense pool
    over dp."""
    dense, paged = one_device["dense"], one_device["paged"]
    assert paged["sessions"] == dense["sessions"]
    assert _same_on_every_rank(world4, "dp4 paged", "sessions") == \
        paged["sessions"]
    assert _same_on_every_rank(world2, "dp2 device", "sessions") == \
        paged["sessions"]
    assert _same_on_every_rank(world2, "dp2 dense", "sessions") == \
        dense["sessions"]


def test_sync_engine_dp_bit_identical(world2, one_device):
    """The sync engine over dp 2: the same tokens on the orchestrator's
    modes and on mode 1, the same accounting."""
    assert _same_on_every_rank(world2, "sync dp2") == one_device["sync"]


# ---------------------------------------------------------------------------
# mp: the same schedule, logits within tolerance
# ---------------------------------------------------------------------------

def _first_divergence(got, base):
    """{rid: index of the first differing token} over the sessions."""
    out = {}
    for rid, (b_tok, *_) in base.items():
        g_tok = got[rid][0]
        diff = [i for i, (a, b) in enumerate(zip(g_tok, b_tok)) if a != b]
        if diff:
            out[rid] = diff[0]
    return out


@pytest.mark.parametrize("layout", ["mp2 unfused", "dp2 mp2 unfused",
                                    *(f"{a} mp2 unfused" for a in MIXERS)])
def test_dp_mp_mesh_completes_same_schedule(layout, world2, world4,
                                            one_device):
    """mp reassociates the row-split sums, so tokens may part only at a
    near tie; every request still finishes on the same tick with the same
    wire bytes and modes, and each live row's logits at each step agree
    with the one-device engine's within ``MP_LOGIT_ATOL``. The mixer
    archs' layouts split their RG-LRU channels or xLSTM heads (and the
    recurrent state with them)."""
    world = world4 if layout == "dp2 mp2 unfused" else world2
    arch = next((a for a in MIXERS if layout.startswith(a)), None)
    base = one_device["unfused" if arch is None else ("unfused", arch)]
    by_rank = {r: world[r][layout] for r in world}
    got = by_rank[0]["sessions"]
    assert set(got) == set(base["sessions"])
    for rid, (b_tok, b_wire, b_modes, b_tick) in base["sessions"].items():
        g_tok, g_wire, g_modes, g_tick = got[rid]
        assert len(g_tok) == len(b_tok)
        assert (g_wire, g_modes, g_tick) == (b_wire, b_modes, b_tick)
    for r in by_rank:
        assert by_rank[r]["sessions"] == got
    # the first tick any session's stream parts (a near tie) bounds the
    # logits compared; tokens[0] is the prefill's, token i the tick
    # admitted + i - 1's
    parted = _first_divergence(got, base["sessions"])
    stop = min((base["admitted"][rid] + i - 1 for rid, i in parted.items()),
               default=None)
    compared = 0
    for r, res in by_rank.items():
        lo, hi = res["rows"]
        assert len(res["tape"]) == len(base["tape"])
        for t, ((live, rows), (b_live, b_rows)) in enumerate(
                zip(res["tape"], base["tape"])):
            assert live == b_live
            if stop is not None and t >= stop:
                break
            for s in live:
                if lo <= s < hi:
                    np.testing.assert_allclose(rows[s - lo], b_rows[s],
                                               rtol=0, atol=MP_LOGIT_ATOL)
                    compared += 1
    assert compared > 0
    for rid, i in parted.items():
        # a stream may part only where the one-device engine saw a near tie
        _, b_rows = base["tape"][base["admitted"][rid] + i - 1]
        top2 = np.sort(b_rows[base["slots"][rid]])[-2:]
        assert top2[1] - top2[0] <= MP_LOGIT_ATOL, (rid, i)


# ---------------------------------------------------------------------------
# migration is mesh-blind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_migration_round_trip(arch, world4, one_device):
    """A live migration between two dp-2 replicas on disjoint rank groups
    decodes exactly what one unsharded engine decodes."""
    name = "migrate qwen" if arch == QWEN else "migrate rg"
    got = _same_on_every_rank(world4, name)
    assert got["ranks"] == [(0, 1), (2, 3)]
    assert got["migrations"] == 1
    # tokens, wire bytes and modes (a finished tick is on the target
    # replica's clock)
    want = one_device[("mobile", arch)]
    assert {r: v[:3] for r, v in got["sessions"].items()} == \
        {r: v[:3] for r, v in want.items()}


def test_snapshot_wire_bits_mesh_invariant(world4, one_device):
    """The snapshot of a session held by rank 2 of a dp-4 engine, on every
    rank, has the one-device snapshot's bytes: paged pages and dense
    rows."""
    for r in world4:
        for paged, got in world4[r]["snapshot dp4"].items():
            want = one_device["snapshot"][paged]
            assert got["slot"] == want["slot"] == 2
            assert got["position"] == want["position"]
            assert got["nbytes"] == want["nbytes"]
            np.testing.assert_array_equal(got["cur_token"],
                                          want["cur_token"])
            assert len(got["wire"]) == len(want["wire"])
            for (ka, a), (kb, b) in zip(got["wire"], want["wire"]):
                assert ka == kb == "raw"
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# pool placement and padding
# ---------------------------------------------------------------------------

def test_pool_states_carry_dp_sharding(world4, models):
    """Rank r of dp 4 holds slot r of a 4-slot dense pool and keeps every
    slot's row (it decodes them all, the others on scratch); gathered rows
    are whole and host-addressable on every rank."""
    cfg, _ = models[QWEN]
    ref_rows = SlotPool(cfg, n_slots=4, cache_len=16).read_rows([2, 0])
    want = [(p, tuple(a.shape)) for p, a in sharding._path_leaves(ref_rows)]
    for r in world4:
        got = world4[r]["pools dp4"]
        assert got["slot_rows"] == (r, r + 1)
        assert all(s[1] == 4 for s in got["slot_state_rows"])
        assert got["read_rows"] == want


def test_paged_arena_padded_to_dp(world4, models):
    """Each shard allocates from its own free list; the pages that can be
    allocated in all are the unsharded pool's, every shard's arena has the
    same page count and a shard's padding pages never enter its list."""
    cfg, _ = models[QWEN]
    ref_pool = PagedPool(cfg, n_slots=4, cache_len=32)
    for r in world4:
        got = world4[r]["pools dp4"]
        assert got["n_pages"] == ref_pool.n_pages
        assert got["free"] == ref_pool.free_page_count == ref_pool.n_pages
        assert sum(got["shard_pages"]) == ref_pool.n_pages
        assert got["arena"] == ref_pool.n_pages // 4 + 1
        assert got["tight_shard_pages"] == [2, 2, 2, 1]
        assert got["tight_arena"] == 3 and got["tight_free"] == 7
        assert got["slot3_pages"] == 1 and got["exhausted"]


# ---------------------------------------------------------------------------
# weights over mp
# ---------------------------------------------------------------------------

def test_shard_params_reassemble_bit_for_bit(world2, models):
    """The two mp ranks' slices of qwen2.5-3b, joined along the rule's
    axis, are the full tree bit for bit; replicated leaves are whole on
    both; the rank's config halves the heads and d_ff."""
    cfg, params = models[QWEN]
    full = {p: a.numpy() for p, a in sharding._path_leaves(params)}
    parts = [world2[r]["shard_params"] for r in sorted(world2)]
    assert [p["coords"] for p in parts] == [(0, 0), (0, 1)]
    specs = sharding.rank_specs(cfg, (("model", 2),),
                                sharding.tree_shapes(params))
    n_split = 0
    for path, whole in full.items():
        spec = specs[path]
        got = [p["flat"][path] for p in parts]
        if "model" not in spec:
            for g in got:
                assert g.tobytes() == whole.tobytes(), path
            continue
        n_split += 1
        joined = np.concatenate(got, axis=spec.index("model"))
        assert joined.tobytes() == whole.tobytes(), path
        assert got[0].shape != whole.shape
    assert n_split == 10       # wq, wk, wv (w and b), wo, gate, up, down
    assert parts[0]["local_cfg"] == (cfg.n_heads // 2, cfg.n_kv_heads // 2,
                                     cfg.head_dim, cfg.d_ff // 2)


def test_local_config_keeps_head_dim():
    """stablelm-3b's head_dim 80 survives the narrowed head count (a
    config built anew would derive 160 from 16 heads)."""
    from repro_torch.configs import get_config
    cfg = get_config("stablelm-3b")
    mesh = object.__new__(sharding.ServingMesh)
    mesh.mp = 2
    local = mesh.local_cfg(cfg)
    assert (local.n_heads, local.n_kv_heads, local.head_dim, local.d_ff) == \
        (16, 16, 80, 3456)
    assert cfg.d_model // local.n_heads == 160


def test_mp_on_moe_rglru_xlstm_raises(world2):
    """mp 2 over MoE expert layers, RG-LRU and xLSTM mixers passes the
    mesh's check on both engines (none raises): the experts, the RG-LRU
    channels and the xLSTM heads split, recurrentgemma's MQA attention
    (one KV head) runs replicated, and the rank's config narrows the
    split widths only."""
    got = _same_on_every_rank(world2, "mp_raises")
    assert len(got) == 6
    for cls in ("ContinuousBatchingEngine", "ServingEngine"):
        splits, heads, d_rnn = got[("mixtral-8x7b", cls)]
        assert splits["mlp"] and not splits["rglru"]
        splits, heads, d_rnn = got[("recurrentgemma-2b", cls)]
        rg = get_reduced(RG)
        assert splits == {"attn": False, "mlp": True, "rglru": True,
                          "mlstm": False, "slstm": False}
        assert (heads, d_rnn) == (rg.n_heads, rg.d_rnn // 2)
        splits, heads, d_rnn = got[("xlstm-125m", cls)]
        assert splits == {"attn": False, "mlp": False, "rglru": False,
                          "mlstm": True, "slstm": True}
        assert heads == get_reduced(XL).n_heads // 2


@pytest.mark.parametrize("arch", MIXERS)
def test_mixers_one_device_tokens_are_jax(arch, one_device, jax_runs):
    """The one-device stream the mixers' mp layouts are held to is the JAX
    reference engine's: tokens, wire bytes, modes, finished ticks."""
    assert one_device[("unfused", arch)]["sessions"] == \
        jax_runs[(arch, False)]


@pytest.mark.parametrize("arch", MIXERS)
def test_mixers_sync_engine_over_mp(arch, world2, one_device):
    """The sync engine with the mixers split over mp 2 decodes the
    one-device tokens on the orchestrator's modes and on mode 1, with the
    same accounting, on both ranks."""
    assert _same_on_every_rank(world2, f"{arch} mp2 sync") == \
        one_device[("sync", arch)]


@pytest.mark.parametrize("arch", MIXERS)
def test_mixers_snapshot_over_mp(arch, world2, one_device):
    """A migration snapshot of an mp-2 engine gathers every recurrent
    leaf whole: the one-device snapshot's leaves, dtypes, shapes and
    bytes, the same bytes on both ranks, each value within the mp
    tolerance of one device's."""
    want = one_device[("snapshot", arch)]
    got = world2[0][f"{arch} mp2 snapshot"]
    for r in world2:
        other = world2[r][f"{arch} mp2 snapshot"]
        assert [e[1].tobytes() for e in other["wire"]] == \
            [e[1].tobytes() for e in got["wire"]]
    for k in ("slot", "position", "nbytes"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["cur_token"], want["cur_token"])
    assert len(got["wire"]) == len(want["wire"])
    for (ka, a), (kb, b) in zip(got["wire"], want["wire"]):
        assert ka == kb == "raw"
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=MP_STATE_RTOL,
                                   atol=MP_LOGIT_ATOL)


def test_serve_launcher_mp_over_rglru(world2):
    """``launch.serve --mp 2 --arch recurrentgemma-2b`` (reduced, bf16)
    serves every request on the group, the same tokens on both ranks."""
    got = _same_on_every_rank(world2, "serve rg mp2", "tokens")
    assert len(got) == 3
    for r in world2:
        res = world2[r]["serve rg mp2"]
        assert res["finished"] == 3
        assert res["mesh"]["mp"] == 2 and res["mesh"]["rank"] == r


def test_workers_load_no_jax(world2, world4):
    """The ranks ran every scenario without loading ``jax`` or the JAX
    package."""
    for world in (world2, world4):
        for r in world:
            assert world[r]["loaded"] == [], world[r]["loaded"]


# ---------------------------------------------------------------------------
# the boundary on a rank's rows
# ---------------------------------------------------------------------------

def test_boundary_sharded_rows_bit_identical(models):
    """``boundary_mixed_sharded`` on a rank's rows (2 of 4, every mode)
    gives those rows of ``boundary_mixed_op`` on the whole batch, bit for
    bit."""
    cfg, params = models[QWEN]
    bank = TB.bank_stack(params["bneck_modes"], cfg.split)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (4, 1, cfg.d_model)).astype(np.float32))
    modes = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    full = ops.boundary_mixed_op(bank, x, modes, dtype=torch.float32)
    member = types.SimpleNamespace(member=True)
    for lo in (0, 2):
        part = ops.boundary_mixed_sharded(bank, x[lo:lo + 2],
                                          modes[lo:lo + 2], member,
                                          dtype=torch.float32)
        assert torch.equal(part, full[lo:lo + 2])
    with pytest.raises(ValueError, match="holds no rows"):
        ops.boundary_mixed_sharded(bank, x, modes, types.SimpleNamespace(
            member=False, rank=3), dtype=torch.float32)


# ---------------------------------------------------------------------------
# validation (no ranks needed)
# ---------------------------------------------------------------------------

def test_serving_mesh_validates_axes():
    with pytest.raises(ValueError):
        serving_mesh(0, 1)
    with pytest.raises(ValueError):
        serving_mesh(1, -2)


def test_serving_mesh_rank_count_error_says_how_to_start_ranks():
    with pytest.raises(ValueError, match="torchrun"):
        serving_mesh(4096, 1)


def test_cluster_rejects_oversubscribed_mesh(models):
    cfg, params = models[QWEN]
    with pytest.raises(ValueError, match="device"):
        EdgeCluster(params, cfg, n_replicas=2, n_slots=2, cache_len=32,
                    dp=4096)
    from repro_torch.serving import Autoscaler
    with pytest.raises(ValueError, match="elastic"):
        EdgeCluster(params, cfg, n_replicas=2, n_slots=2, cache_len=32,
                    dp=1, autoscaler=Autoscaler())


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_launchers_run_on_the_group(world2):
    """Under an initialized group ``launch.serve --dp 2`` serves on its
    ranks (the one-device tokens; launches summed over ranks: none on the
    CPU) and ``bench_serving --slot-scaling 1,2`` finishes every row's
    workload, each dp row at least ``SHARD_FLOOR`` 0.1 of dp 1's tok/s
    (the reference gate's rule)."""
    from repro_torch.launch import serve
    base = serve.main(SERVE + ["--engine", "continuous"])
    for r in world2:
        got = world2[r]["launchers"]
        assert got["tokens"] == base["tokens"] and got["finished"] == 4
        assert got["mesh"]["world"] == 2 and got["mesh"]["rank"] == r
        assert set(got["mesh"]["launches"].values()) == {0}
    rows = world2[0]["launchers"]["slot_scaling"]["rows"]
    assert [row["dp"] for row in rows] == [1, 2]
    for row in rows:
        assert row["finished"] == row["requests"] == 4 * row["dp"]
        assert row["decode_tok_per_s"] >= 0.1 * rows[0]["decode_tok_per_s"]


def test_serve_starts_its_own_ranks():
    """Outside a group ``launch.serve --dp 2`` starts two gloo ranks
    itself and returns rank 0's summary: the one-device sync engine's
    tokens."""
    from repro_torch.launch import serve
    base = serve.main(SERVE + ["--engine", "sync"])
    got = serve.main(SERVE + ["--engine", "sync", "--dp", "2"])
    assert got["generated"] == base["generated"]
    assert got["mesh"]["world"] == 2 and got["mesh"]["backend"] == "gloo"
