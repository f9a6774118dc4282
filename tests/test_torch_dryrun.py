"""The port's dry run (``repro_torch.launch.dryrun``) and its collective
recorder (``launch.roofline.CollectiveRecorder``), against the JAX
package's dry run.

Every case runs in a subprocess (``tests/torch_dry.py``): the port's fake
process group is global, and importing the reference's dry run forces 512
host devices.

- The recorder, on a fake world of 4 with meta tensors: a known sequence
  of all_reduce, broadcast, all_gather, reduce_scatter, all_to_all and a
  send / receive pair, each counted once under its kind with its result's
  bytes and its group's size, and the port's moves (``models/
  collectives.py``) under the reference's kind names. It replaces the
  reference's ``_shape_bytes`` property test (the port parses no HLO).
- The dry run of reduced configs at (data 2, model 2) on a fake world of
  4: qwen2.5-3b (train and decode), phi3.5-moe (train, without and with
  ``moe_ep``) and recurrentgemma-2b (train). Each argument leaf's local
  shape is the reference's shard shape (``NamedSharding(mesh, spec)
  .shard_shape`` over ``repro.launch.dryrun.abstract_params`` /
  ``abstract_opt_state`` / ``input_specs`` / ``abstract_decode_state`` on
  a (2, 2) mesh of four of its forced host devices) except where a
  difference ``ROADMAP.md`` lists moves an axis, and
  ``argument_size_in_bytes`` is their sum. Rank 0 and rank 3 record the
  same ordered list (the run raises otherwise; a perturbed list must make
  it raise). Variants: the pod pipeline (``pipeline1``) at (pod 2, data
  1, model 2), ``qtp8`` and ``kv_bits=8``; unsupported combinations raise
  with their reason.
- ``bench_roofline`` and ``gen_experiments`` over the records the port
  wrote: the reference's functions, their ``RESULTS_DIR`` set to that
  directory, print the same lines and table.
- Importing the dry run initialises no process group and sets no
  environment variable.
"""
import importlib.util
import json
import math
import os

import pytest

import torch_dry

ROOT = torch_dry.ROOT
MESH = {"data": 2, "model": 2}
#: (label, arch, kind, moe_ep)
CASES = [("dense train", "qwen2.5-3b", "train", False),
         ("dense decode", "qwen2.5-3b", "decode", False),
         ("moe train", "phi3.5-moe-42b-a6.6b", "train", False),
         ("moe train ep", "phi3.5-moe-42b-a6.6b", "train", True),
         ("recurrent train", "recurrentgemma-2b", "train", False)]
SHAPE = {"train": ("t", 64, 8), "decode": ("d", 64, 8),
         "prefill": ("p", 64, 8)}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun_torch"))


@pytest.fixture(scope="module")
def port(records):
    """The port's dry run of every case, the variants, the refusals and
    a perturbed coherence check."""
    return torch_dry.run_script(f"""
        import json
        from repro_torch.configs import get_reduced
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun
        SHAPE = {SHAPE!r}
        out = {{"cases": {{}}, "variants": {{}}, "refused": {{}}}}

        def one(arch, kind, mesh, **kw):
            return dryrun.run_one(
                arch, "decode_32k" if kind == "decode" else "train_4k",
                cfg=get_reduced(arch), shape_cfg=ShapeConfig(
                    *SHAPE[kind], kind=kind), mesh_shape=mesh,
                results_dir={records!r}, leaves=True, verbose=False, **kw)

        for label, arch, kind, ep in {CASES!r}:
            out["cases"][label] = one(arch, kind, {MESH!r}, moe_ep=ep)
        out["variants"]["pipeline1"] = one(
            "qwen2.5-3b", "train", {{"pod": 2, "data": 1, "model": 2}},
            variant="pipeline1", save=False)
        out["variants"]["qtp8"] = one("stablelm-3b", "prefill", {MESH!r},
                                      variant="qtp8", save=False)
        out["variants"]["kv8"] = one("qwen2.5-3b", "decode", {MESH!r},
                                     kv_bits=8, save=False)
        for name, kw in (
                ("pipeline on decode", dict(kind="decode",
                                            variant="pipeline0")),
                ("moe_ep dense", dict(kind="train", moe_ep=True)),
                ("batch2d", dict(kind="train", act_policy="batch2d"))):
            kind = kw.pop("kind")
            try:
                one("qwen2.5-3b", kind, {MESH!r}, save=False, **kw)
                out["refused"][name] = None
            except ValueError as e:
                out["refused"][name] = str(e)
        real = dryrun.rank_run

        def perturbed(cfg, sc, shape, rank, **kw):
            r = real(cfg, sc, shape, rank, **kw)
            if rank:
                r["events"] = r["events"][:-1]
            return r

        dryrun.rank_run = perturbed
        try:
            one("qwen2.5-3b", "decode", {MESH!r}, save=False)
            out["incoherent"] = None
        except RuntimeError as e:
            out["incoherent"] = str(e)
        print(json.dumps(out))
    """, timeout=600)


@pytest.fixture(scope="module")
def ref():
    """The reference's leaves on a (2, 2) mesh: {label: {leaf: [global
    shape, itemsize, spec]}}."""
    return torch_dry.run_script(f"""
        from repro.launch import dryrun as RD
        import json
        import jax
        import numpy as np
        from jax.sharding import Mesh
        from repro.configs import get_reduced
        from repro.configs.base import ShapeConfig
        SHAPE = {SHAPE!r}
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                    ("data", "model"))

        def name(k):
            for a in ("key", "idx", "name"):
                if hasattr(k, a):
                    return str(getattr(k, a))
            return str(k)

        def leaves(tree, prefix):
            out = {{}}
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
                spec = list(x.sharding.spec)
                spec += [None] * (len(x.shape) - len(spec))
                out[prefix + "/" + "/".join(name(k) for k in path)] = [
                    list(x.shape), np.dtype(x.dtype).itemsize,
                    [list(a) if isinstance(a, tuple) else a for a in spec]]
            return out

        out = {{}}
        for label, arch, kind, ep in {CASES!r}:
            cfg = get_reduced(arch)
            sc = ShapeConfig(*SHAPE[kind], kind=kind)
            params, _ = RD.abstract_params(cfg, mesh)
            got = leaves(params, "params")
            if kind == "train":
                got.update(leaves(RD.abstract_opt_state(params, mesh), "opt"))
                got.update(leaves(RD.input_specs(cfg, sc, mesh, "seq"),
                                  "batch"))
            else:
                got.update(leaves(RD.abstract_decode_state(cfg, sc, mesh),
                                  "states"))
                shapes = RD.token_batch_shapes(cfg, sc.global_batch,
                                               sc.seq_len, "decode")
                tok = RD._sds(shapes["tokens"], jax.numpy.int32, mesh,
                              RD.sharding.batch_pspec(
                                  mesh, len(shapes["tokens"]),
                                  sc.global_batch))
                got.update(leaves({{"tokens": tok}}, "batch"))
            out[label] = got
        print(json.dumps(out))
    """, timeout=600)


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _shard(shape, spec):
    return [d // math.prod(MESH[a] for a in _axes(e))
            for d, e in zip(shape, spec)]


def _departed(leaf, spec, cfg, kind):
    """The reference's spec of ``leaf`` with the port's listed
    differences applied (ROADMAP.md, "Differences, not faults"): the
    embedding, final norm, LM head and bank replicate over model; a block
    whose sizes do not divide the model axis runs replicated
    (``check_model_parallel``); the serving mesh holds its weights whole
    over data, and its KV cache splits only by heads."""
    from repro_torch.models import sharding
    group, _, path = leaf.partition("/")
    if group == "opt":
        _, _, path = path.partition("/")
    drop = set()
    if group in ("params", "opt") and path:
        if not path.startswith("layers/"):
            drop.add("model")
        elif not sharding.check_model_parallel(cfg, MESH["model"])[
                sharding._layer_kind(path, cfg)]:
            drop.add("model")
        if kind == "decode":
            drop.add("data")
    if group == "states" and path.rsplit("/", 1)[-1] in sharding.KV_LEAVES \
            and not sharding.attn_sharded(cfg, MESH["model"]):
        drop.add("model")
    return [None if not _axes(e) else
            (lambda kept: None if not kept else
             kept[0] if len(kept) == 1 else kept)(
                [a for a in _axes(e) if a not in drop]) for e in spec]


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_argument_bytes_match_reference_shards(port, ref, label):
    from repro_torch.configs import get_reduced
    arch, kind = next((c[1], c[2]) for c in CASES if c[0] == label)
    cfg = get_reduced(arch)
    rec = port["cases"][label]
    got = {k: v for k, v in rec["argument_leaves"].items()}
    want = ref[label]
    assert sorted(got) == sorted(want)
    total, moved = 0, []
    for leaf, (shape, itemsize, spec) in want.items():
        local = _shard(shape, _departed(leaf, spec, cfg, kind))
        assert got[leaf][0] == local, (leaf, got[leaf][0], local, spec)
        if local != _shard(shape, spec):
            moved.append(leaf)
        total += math.prod(local) * itemsize
    assert rec["memory_analysis"]["argument_size_in_bytes"] == total
    # the departures are the listed ones, nothing else
    if kind == "train":
        assert any(not k.split("/", 2)[-1].startswith("layers/")
                   for k in moved if k.startswith("params/"))


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_ranks_record_the_same_collectives(port, label):
    rec = port["cases"][label]
    assert rec["ranks_checked"] == [0, 3]
    assert rec["rank_coords"][0] != rec["rank_coords"][1]
    assert all(a != b for a, b in zip(*(c.values()
                                        for c in rec["rank_coords"])))
    assert rec["collective_events"] > 0
    assert rec["collective_bytes_per_device"] == sum(
        v["bytes"] for v in rec["collectives"].values())
    assert "temp_size_in_bytes" not in rec["memory_analysis"]


def test_incoherent_ranks_raise(port):
    assert port["incoherent"] and "different collectives" in \
        port["incoherent"]


def test_variants(port):
    pipe = port["variants"]["pipeline1"]
    assert pipe["collectives"]["collective-permute"]["count"] > 0
    assert pipe["ranks_checked"] == [0, 3]
    qtp = port["variants"]["qtp8"]
    assert qtp["collectives"]["all-gather"]["count"] > 0
    assert qtp["collectives"]["reduce-scatter"]["count"] > 0
    kv8 = port["variants"]["kv8"]
    dense = port["cases"]["dense decode"]
    assert kv8["memory_analysis"]["argument_size_in_bytes"] < \
        dense["memory_analysis"]["argument_size_in_bytes"]
    assert kv8["hbm_bytes_breakdown"]["kv_cache"] < \
        dense["hbm_bytes_breakdown"]["kv_cache"]


def test_unsupported_combinations_raise_with_reason(port):
    for name, reason in port["refused"].items():
        assert reason, f"{name} was not refused"


def _reader(path, name, results_dir):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.RESULTS_DIR = results_dir
    return mod


def test_readers_match_reference(port, records, capsys):
    from repro_torch.benchmarks import bench_roofline, gen_experiments
    assert len(os.listdir(records)) == len(CASES)
    ref_roof = _reader(os.path.join(ROOT, "benchmarks", "bench_roofline.py"),
                       "_ref_bench_roofline", records)
    ref_gen = _reader(os.path.join(ROOT, "benchmarks", "gen_experiments.py"),
                      "_ref_gen_experiments", records)
    ref_roof.main()
    want = capsys.readouterr().out.splitlines()
    assert bench_roofline.lines(records) == want
    assert len(want) == len(CASES)
    for variants in (False, True):
        got = gen_experiments.table("2_2", variants, records)
        assert got == ref_gen.table("2_2", variants)
    assert gen_experiments.table("2_2", False, records).count("\n") == \
        1 + len(CASES) - 1          # header, rule, the baseline records
    with open(os.path.join(records, sorted(os.listdir(records))[0])) as f:
        assert "roofline" in json.load(f)


def test_import_sets_nothing():
    out = torch_dry.run_script("""
        import json, os
        before = dict(os.environ)
        import torch.distributed as dist
        import repro_torch.launch.dryrun
        import repro_torch.launch.mesh
        print(json.dumps({"env": dict(os.environ) == before,
                          "pg": dist.is_initialized()}))
    """)
    assert out == {"env": True, "pg": False}


def test_recorder_counts_a_known_sequence():
    out = torch_dry.run_script("""
        import json
        import torch
        import torch.distributed as dist
        from repro_torch.launch import dryrun, roofline
        from repro_torch.models import collectives as CL
        m = torch.device("meta")
        with dryrun.fake_world(1, 4):
            g = dist.new_group([0, 1])
            x = torch.empty(8, 6, device=m)
            with roofline.CollectiveRecorder() as rec:
                dist.all_reduce(x)
                dist.broadcast(torch.empty(3, dtype=torch.int64, device=m),
                               0)
                out = torch.empty(16, 6, device=m)
                dist.all_gather_into_tensor(out, x, group=g)
                half = torch.empty(4, 6, device=m)
                dist.reduce_scatter_tensor(half, x, group=g)
                dist.all_to_all_single(torch.empty_like(x), x)
                dist.isend(x, 0).wait()
                dist.irecv(torch.empty(2, 3, dtype=torch.bfloat16,
                                       device=m), 2).wait()
            with roofline.CollectiveRecorder() as moves:
                CL.gather_raw(x, g, 0)
                CL.scatter_sum_raw(x, g, 0)
                CL.all_to_all_raw(x.reshape(4, 12), dist.group.WORLD)
                CL.ppermute_raw(x, g, [(0, 1)])
        print(json.dumps({"events": rec.events, "summary": rec.summary(),
                          "moves": moves.events}))
    """)
    assert [tuple(e) for e in out["events"]] == [
        ("all-reduce", 4, 192), ("broadcast", 4, 24), ("all-gather", 2, 384),
        ("reduce-scatter", 2, 96), ("all-to-all", 4, 192),
        ("collective-permute", 4, 192), ("collective-permute", 4, 12)]
    s = out["summary"]
    assert s["collective-permute"] == {"bytes": 204, "count": 2}
    assert s["broadcast"] == {"bytes": 24, "count": 1}
    assert [tuple(e) for e in out["moves"]] == [
        ("all-gather", 2, 384), ("reduce-scatter", 2, 96),
        ("all-to-all", 4, 192), ("collective-permute", 2, 192)]
