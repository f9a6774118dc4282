"""Live session migration in the port (``serving/migration.py``).

The pools' row and page I/O round-trips bit for bit on every state layout
(the paged arena; the dense pool's stacked attention KV, RG-LRU and xLSTM
carries). A session that live-migrates between replicas mid-generation
decodes exactly the tokens, modes and wire bytes of an unmigrated engine,
on both loops and with the crossing inside a dispatched window. The
snapshot of a session equals the reference's snapshot of the same session
(reduced f32, weights converted from JAX's ``init_split_params``): the
same leaves in the same order and shapes, the same ``nbytes`` raw and at 8
bits, values within the plain path's float32 arithmetic. A paged target
parks a snapshot its arena cannot cover, and replicas share their weight
tensors.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.core.channel import MobilityChannel as JMobility
from repro.models import sharding as j_sharding
from repro.serving import batcher as JB
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import default_orchestrator as j_orch
from repro.serving import extract_session as j_extract
from repro.training import checkpoint
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import split as SP
from repro_torch.core.channel import MobilityChannel
from repro_torch.models import transformer as T
from repro_torch.serving import (ContinuousBatchingEngine, EdgeCluster,
                                 PagedPool, Request, SlotPool,
                                 default_orchestrator, extract_session,
                                 inject_session)

ARCHS = ["qwen2.5-3b", "recurrentgemma-2b", "xlstm-125m"]


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
    """On the CPU ``jnp.asarray`` may alias a numpy array, and the
    reference's paged pool hands rows of its numpy block table to work
    that runs later (the window, on the pipeline thread; the injection's
    page scatter, dispatched asynchronously) while the main thread zeroes
    the row of a session that finishes at dispatch: under load the
    reference's token streams then vary (ROADMAP Queue 3). Give the window
    a copy, as ``block_table``'s docstring promises, and let the scatter
    finish before ``write_pages`` returns."""
    write_pages = JB.PagedPool.write_pages

    def block_table(self):
        return j_sharding.shard_batch(jax.numpy.asarray(
            self.block_np[:, :self.table_width()].copy()), self.mesh)

    def write_pages_landed(self, slot, blocks, position):
        write_pages(self, slot, blocks, position)
        jax.block_until_ready(self.states)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB.PagedPool, "block_table", block_table)
        mp.setattr(JB.PagedPool, "write_pages", write_pages_landed)
        yield


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg = get_reduced(arch)
        out[arch] = (cfg, SP.init_split_params(
            torch.Generator().manual_seed(0), cfg))
    return out


def _prompt(cfg, n=4, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, size=n).astype(np.int32)


def _mobility(cross_at, *, n_ticks=64, mod=MobilityChannel):
    return mod([0] * cross_at + [1] * n_ticks, [2e6, 2e6], detach_factor=1.0)


def _fill(states, seed: int):
    """A recognizable pattern in every leaf (integers for integer leaves)."""
    g = torch.Generator().manual_seed(seed)
    for leaf in T.tree_leaves(states):
        r = torch.randn(leaf.shape, generator=g)
        leaf.copy_((r * 100).to(leaf.dtype) if not leaf.is_floating_point()
                   else r.to(leaf.dtype))


def _snap(states):
    return [t.clone() for t in T.tree_leaves(states)]


# ---------------------------------------------------------------------------
# pool I/O round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dense_read_write_rows_round_trip(arch, models):
    """``write_rows(read_rows(s), s)`` is an identity on every dense layout,
    and rows cross-copy bit for bit."""
    cfg, _ = models[arch]
    pool = SlotPool(cfg, n_slots=4, cache_len=16)
    _fill(pool.states, 1)
    before = _snap(pool.states)
    rows = pool.read_rows([2, 0])
    axis = 1 if cfg.homogeneous else 0
    assert all(t.shape[axis] == 2 for t in T.tree_leaves(rows))
    pool.write_rows(rows, [2, 0], [0, 0])
    for a, b in zip(before, T.tree_leaves(pool.states)):
        assert torch.equal(a, b)
    pool.write_rows(pool.read_rows([2, 2]), [1, 3], [5, 6])
    for leaf in T.tree_leaves(pool.states):
        row = leaf.movedim(axis, 0)
        assert torch.equal(row[1], row[2]) and torch.equal(row[3], row[2])
    assert list(pool.positions[[1, 3]]) == [5, 6]


def test_paged_read_write_round_trips(models):
    """``read_rows`` / ``write_rows`` and ``read_pages`` / ``write_pages``
    on the paged arena: identities over the allocated pages, a page block
    lands in freshly allocated pages of another slot with the same logical
    rows, and unallocated chunks read as zeros."""
    cfg, _ = models["qwen2.5-3b"]
    pool = PagedPool(cfg, n_slots=3, cache_len=32, page_len=8)
    for s, rows in ((0, 19), (1, 8), (2, 1)):
        pool.acquire()
        pool.alloc_pages(s, rows)
        pool.positions[s] = rows
    _fill(pool.states, 2)
    before = _snap(pool.states)
    dense = pool.read_rows([0, 1])
    nb = pool.table_width()
    for leaf in T.tree_leaves(dense):
        assert leaf.shape[2] == nb * pool.page_len
        assert not leaf[:, 1, 8:].any()           # slot 1 holds one page
    pool.write_rows(dense, [0, 1], [19, 8])
    for a, b in zip(before, T.tree_leaves(pool.states)):
        assert torch.equal(a, b)
    blocks = pool.read_pages(0)
    assert T.tree_leaves(blocks)[0].shape[1] == 3
    pool.release(2)
    slot = pool.acquire()
    pool.write_pages(slot, blocks, 19)
    assert int(pool.pages_used[slot]) == 3 and pool.positions[slot] == 19
    assert set(pool.block_np[slot, :3]).isdisjoint(pool.block_np[0, :3])
    again = pool.read_rows([0, slot])
    for leaf in T.tree_leaves(again):
        assert torch.equal(leaf[:, 0], leaf[:, 1])


# ---------------------------------------------------------------------------
# migrated streams are bit-identical
# ---------------------------------------------------------------------------

def _run_single(params, cfg, reqs, **kw):
    eng = ContinuousBatchingEngine(params, cfg, n_slots=2, cache_len=48,
                                   orchestrator=default_orchestrator(cfg),
                                   **kw)
    done = eng.run(reqs)
    eng.close()
    return {s.request.rid: s for s in done}


def _run_cluster(params, cfg, reqs, **kw):
    cluster = EdgeCluster(params, cfg, n_replicas=2, n_slots=2,
                          cache_len=48, placement="best-channel", **kw)
    done = cluster.run(reqs)
    st = cluster.stats()
    cluster.close()
    return {s.request.rid: s for s in done}, st


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loop", ["device", "host", "mid_window"])
def test_migrated_stream_bit_identical(arch, loop, models):
    """One session crosses cells mid-generation and live-migrates; another
    never moves. Both decode exactly what one unmigrated engine decodes.
    ``mid_window``: windows of 8 ticks, the crossing 4 decode ticks into
    the first, so extraction lands the in-flight window first."""
    cfg, params = models[arch]
    kw = {"device": {}, "host": {"host_loop": True},
          "mid_window": {"max_window": 8}}[loop]

    def reqs():
        return [Request(rid=0, prompt=_prompt(cfg, seed=3),
                        max_new_tokens=20 if loop == "mid_window" else 12,
                        channel=_mobility(5)),
                Request(rid=1, prompt=_prompt(cfg, seed=4),
                        max_new_tokens=9, channel=_mobility(60))]

    base = _run_single(params, cfg, reqs(), **kw)
    got, st = _run_cluster(params, cfg, reqs(), handover="migrate", **kw)
    assert st["migrations"] == 1 and st["requests_finished"] == 2
    for rid in base:
        assert got[rid].tokens == base[rid].tokens, (arch, rid)
        assert got[rid].mode_counts == base[rid].mode_counts, (arch, rid)
        assert got[rid].wire_bytes == base[rid].wire_bytes, (arch, rid)
    m = got[0].migrations[0]
    assert m["kind"] == "migrate" and m["bytes"] > 0
    assert (m["from_replica"], m["to_replica"]) == (0, 1)
    assert got[0].transfer_s > base[0].transfer_s
    if loop == "mid_window":
        assert st["mean_handover_latency_ticks"] > 0


def test_quantized_snapshot_ships_fewer_bytes_and_completes(models):
    cfg, params = models["qwen2.5-3b"]

    def reqs():
        return [Request(rid=0, prompt=_prompt(cfg, seed=9),
                        max_new_tokens=14, channel=_mobility(5))]

    raw, st_raw = _run_cluster(params, cfg, reqs(), handover="migrate")
    q8, st_q8 = _run_cluster(params, cfg, reqs(), handover="migrate",
                             snapshot_bits=8)
    assert st_raw["migrations"] == st_q8["migrations"] == 1
    assert len(q8[0].tokens) == len(raw[0].tokens) == 14
    assert 0 < st_q8["migration_bytes"] < 0.53 * st_raw["migration_bytes"]
    assert q8[0].migrations[0]["bits"] == 8


# ---------------------------------------------------------------------------
# snapshots against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def converted():
    out = {}
    for arch in ("qwen2.5-3b", "recurrentgemma-2b"):
        jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
        jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
        out[arch] = (jcfg, jp, tcfg,
                     params_from_flat(checkpoint._flatten(jp), device="cpu"))
    return out


def _session_pair(converted, arch, bits):
    """Both packages' engines (host loop) run the same two sessions five
    ticks, then snapshot session 1."""
    jcfg, jp, tcfg, tp = converted[arch]
    snaps = []
    for eng_cls, req_cls, orch, mob, cfg, p, extract in (
            (JEngine, JRequest, j_orch, JMobility, jcfg, jp, j_extract),
            (ContinuousBatchingEngine, Request, default_orchestrator,
             MobilityChannel, tcfg, tp, extract_session)):
        eng = eng_cls(p, cfg, n_slots=2, cache_len=32, orchestrator=orch(cfg),
                      host_loop=True)
        for i in range(2):
            eng.submit(req_cls(rid=i, prompt=_prompt(cfg, 9 + 2 * i, seed=i),
                               max_new_tokens=12,
                               channel=_mobility(60, mod=mob)))
        for _ in range(5):
            eng.step()
        snaps.append(extract(eng, 1, bits=bits))
    return snaps


@pytest.mark.parametrize("arch,bits", [("qwen2.5-3b", 0), ("qwen2.5-3b", 8),
                                       ("recurrentgemma-2b", 0)])
def test_snapshot_matches_reference(arch, bits, converted):
    js, ts = _session_pair(converted, arch, bits)
    assert ts.nbytes == js.nbytes and ts.paged == js.paged
    assert (ts.position, ts.page_len, ts.bits) == \
        (js.position, js.page_len, js.bits)
    assert np.array_equal(ts.cur_token, np.asarray(js.cur_token))
    assert ts.session.tokens == js.session.tokens
    assert len(ts.wire) == len(js.wire)
    for a, b in zip(ts.wire, js.wire):
        assert a[0] == b[0]
        if a[0] == "raw":
            assert a[1].shape == b[1].shape
            np.testing.assert_allclose(a[1], np.asarray(b[1], a[1].dtype),
                                       rtol=1e-5, atol=1e-5)
        else:
            assert a[1].shape == b[1].shape and a[1].dtype == np.int8
            assert np.abs(a[1].astype(int) - b[1].astype(int)).max() <= 1
            np.testing.assert_allclose(a[2], b[2], rtol=1e-5, atol=1e-7)
    if bits:
        raw = _session_pair(converted, arch, 0)[1]
        assert ts.nbytes < 0.53 * raw.nbytes


# ---------------------------------------------------------------------------
# primitives: park, refuse, share weights
# ---------------------------------------------------------------------------

def test_inject_parks_on_full_pool_and_short_arena(models):
    """Extract detaches the session and its link state; inject refuses a
    full pool and an arena that cannot cover the session's worst-case
    pages, then lands once the blocker retires, and the session finishes
    with its whole budget."""
    cfg, params = models["qwen2.5-3b"]
    src = ContinuousBatchingEngine(params, cfg, n_slots=2, cache_len=48,
                                   orchestrator=default_orchestrator(cfg),
                                   max_window=2)
    dst = ContinuousBatchingEngine(params, cfg, n_slots=2, cache_len=16,
                                   n_pages=4, max_window=2,
                                   orchestrator=default_orchestrator(cfg))
    dst.submit(Request(rid=99, prompt=_prompt(cfg, seed=1),
                       max_new_tokens=20, channel=_mobility(60)))
    src.submit(Request(rid=0, prompt=_prompt(cfg, seed=2),
                       max_new_tokens=12, channel=_mobility(60)))
    for _ in range(3):
        src.step()
        dst.step()
    with pytest.raises(KeyError):
        extract_session(src, rid=12345)
    snap = extract_session(src, rid=0)
    assert not src.active and src.pool.n_free == src.pool.n_slots
    assert snap.link is not None and snap.position == snap.session.pos
    assert dst.pool.n_free == 1                    # a slot, but few pages
    assert not inject_session(dst, snap)
    # the parked snapshot is host data: the source slot serving another
    # session changes none of it
    tok = snap.cur_token.copy()
    src.run([Request(rid=5, prompt=_prompt(cfg, seed=6), max_new_tokens=3)])
    assert np.array_equal(snap.cur_token, tok)
    dst.run()                                      # the blocker finishes
    assert inject_session(dst, snap)
    done = dst.run()
    assert any(s.request.rid == 0 and len(s.tokens) == 12 for s in done)
    other = ContinuousBatchingEngine(params, cfg, n_slots=1, cache_len=48,
                                     page_len=16)
    with pytest.raises(ValueError, match="page_len"):
        inject_session(other, snap)
    dense = ContinuousBatchingEngine(params, cfg, n_slots=1, cache_len=48,
                                     paged=False)
    with pytest.raises(ValueError, match="pool kind"):
        inject_session(dense, snap)


def test_replicas_share_weight_tensors(models):
    """N replicas (and a scale-up) cost N pools, not N models: every
    replica's weight tensor is the caller's, by ``data_ptr``."""
    cfg, params = models["qwen2.5-3b"]
    ptrs = sorted(t.data_ptr() for t in T.tree_leaves(params))
    cluster = EdgeCluster(params, cfg, n_replicas=2, n_slots=1, cache_len=16)
    cluster.scale_up()
    assert len(cluster.replicas) == 3
    for eng in cluster.replicas:
        assert sorted(t.data_ptr() for t in T.tree_leaves(eng.params)) == \
            ptrs
    arenas = {T.tree_leaves(e.pool.states)[0].data_ptr()
              for e in cluster.replicas}
    assert len(arenas) == 3
    rcfg, rparams = models["recurrentgemma-2b"]
    shared = {t.data_ptr() for t in T.tree_leaves(rparams)}
    engines = [ContinuousBatchingEngine(rparams, rcfg, n_slots=1,
                                        cache_len=16) for _ in range(2)]
    for eng in engines:
        own = {t.data_ptr() for t in T.tree_leaves(eng.params)} - shared
        # only the RG-LRU layers' float32 gate forms are the engine's own
        assert len(own) <= 4 * rcfg.n_layers
