"""The port's training mesh (``sharding.TrainMesh``, ``loop.make_train_step
(mesh=)``, ``launch.train --mp``) on gloo ranks, against the port's
one-device runs and the JAX package's (``make_train_step``,
``train_cascade`` and the continuous engine).

Reduced configs in float32 (the JAX init carried across), batches from
``MarkovTokenSource``. Four ranks:

- two steps of qwen2.5-3b at (data 2, model 2) and (data 4, model 1),
  both FSDP over data (each rank holds its slice of every leaf whose
  reference spec has a data entry that divides, and AdamW's moments of
  those slices only; the leaf shapes held to the reference's
  ``param_pspecs`` on an abstract mesh):
  each step's loss within ``LOSS_REL`` of both one-device runs', the
  clipped global norm within ``GRAD_REL`` (the mesh sums the squares of
  the model-split leaves over the model group, the replicated ones once),
  the ranks' slices (``shard_train_params``) gathered back to the
  converted tree bit for bit (``gather_train_params``), the first step's
  parameters gathered from the ranks within the update rule of
  ``tests/test_torch_train_loop.py`` of the one-device step's (an element
  whose gradient is under ``SMALL_G`` of its leaf's largest may move by
  up to 2 lr: Adam's first update is about lr sign(g)), and every
  replicated leaf bit-identical on every rank after each step;
- Algorithm 1 (``cascade.train_cascade`` with a ``MeshRun``) at (data 2,
  model 2), two steps a phase: every logged loss within ``LOSS_REL`` of
  the port's one-device cascade's and the JAX package's ``train_cascade``
  on the same weights and batches (phase 2 freezes the backbone, and
  every rank still recomputes and reduces the same layers);
- one step at (data 2, model 2) under ``roofline.CollectiveRecorder``:
  the recorder's kinds, counts and result bytes equal the step's own
  ``collectives.COUNTS``, and the dry run (``launch/dryrun.py``) of the
  same step on a fake world of 4 records the same ordered list;
- ``examples/expert_parallel_moe.run`` at (data 2, model 2) on reduced
  phi3.5-moe: the example's three assertions (the EP run issues
  all-to-alls, the per-step loss gap under 0.5, the EP loss decreasing);
- the collectives' all_reduce forms (what gloo runs on CUDA tensors) give
  the native forms' bits: gathers, all_to_all and ppermute of float32
  (``-0.0`` and NaN included), bf16 and int8 tensors; scatter-sums of
  integer-valued floats; and the backward of each differentiable pair is
  its transpose.

Two ranks:

- recurrentgemma-2b and xlstm-125m at (data 1, model 2): the RG-LRU
  channels and the xLSTM heads split over model; two steps as below
  against both one-device runs, the JAX package's ``make_train_step``
  among them;
- phi3.5-moe at (data 1, model 2) without ``moe_ep``: each rank holds two
  of the four experts; two steps as above (losses and norms against both
  one-device runs, parameters, replicated leaves);
- the continuous engine serving phi3.5-moe over mp 2 decodes the
  one-device engines' tokens, the port's and the JAX package's (the
  router's k = 2 choices land on one rank or two, and each kept row is
  summed once, so the float32 logits part only by the attention's two
  partial sums);
- ``launch.train --mp 2`` on the ranks: the one-device launcher's losses
  within ``LAUNCH_LOSS_REL`` (bf16) and a checkpoint, written once by
  rank 0 from the gathered slices, that ``repro.training.checkpoint.
  restore`` reads into the JAX template; the same of ``launch.train``
  on (data 2, model 1), FSDP, whose ranks each hold half the data-split
  bytes; and ``launch.train --mp 2`` of recurrentgemma-2b (Algorithm 1,
  ``--cascade``) and xlstm-125m within ``LAUNCH_LOSS_REL`` of one device.
"""
import dataclasses
import importlib
import os
import types

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.configs import get_reduced
from repro_torch import serving as TS
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import flat_from_params, params_from_flat
from repro_torch.core import cascade as TC
from repro_torch.core import split as SP
from repro_torch.models import collectives as CL
from repro_torch.models import sharding
from repro_torch.training import loop as TL
from repro_torch.training import optimizer as TO

QWEN, PHI = "qwen2.5-3b", "phi3.5-moe-42b-a6.6b"
RG, XL = "recurrentgemma-2b", "xlstm-125m"
ARCHS = (QWEN, PHI, RG, XL)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
STEP_REL = 1e-5
SMALL_G = 1e-3
LAUNCH_LOSS_REL = 1e-2
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=100)
LAYOUTS = {"data2 model2": 2, "data4": 1}     # model axis
LAUNCH = ["--arch", QWEN, "--reduced", "--device", "cpu", "--steps", "2",
          "--batch", "2", "--seq", "16", "--lr", "3e-3"]
#: the mixer archs' launches on (data 1, model 2) (recurrentgemma under
#: Algorithm 1; xlstm's time loops at a shorter sequence)
MIXER_LAUNCH = {RG: ["--arch", RG, "--cascade", "--seq", "16"],
                XL: ["--arch", XL, "--seq", "8"]}
MIXER_ARGS = ["--reduced", "--device", "cpu", "--steps", "2", "--batch",
              "2", "--lr", "3e-3"]


def _cfg(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _batches(arch, n=2):
    src = __import__("repro_torch.data.tokens", fromlist=["x"])
    source = src.MarkovTokenSource(_cfg(arch), seed=0)
    return [source.batch(4, 16, s) for s in range(n)]


def _bits(a):
    return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()


def _replicated(params, mesh, cfg):
    split = sharding.split_axes(params, mesh, cfg=cfg,
                                shapes=SP.param_shapes(cfg))
    return {path: _bits(a).tobytes() for (path, a), (_, s) in zip(
        sharding._path_leaves(params), sharding._path_leaves(split))
        if s is None}


def _steps(payload, arch, model):
    """Two steps on the (data, model) mesh: metrics, the gathered first
    step's parameters, the replicated leaves' bits after each step."""
    mesh = sharding.train_mesh(model, device="cpu")
    cfg = _cfg(arch)
    params = sharding.shard_train_params(
        params_from_flat(payload[arch], device="cpu"), mesh, cfg=cfg)
    back = flat_from_params(sharding.gather_train_params(
        params, mesh, cfg=cfg, shapes=SP.param_shapes(cfg)))
    step = TL.make_train_step(cfg, TrainConfig(**TCFG), mesh=mesh,
                              donate=False)
    state = TO.init(params)
    out = {"metrics": [], "replicated": [],
           "shapes": {path: (tuple(a.shape), tuple(m.shape)) for (path, a),
                      (_, m) in zip(sharding._path_leaves(params),
                                    sharding._path_leaves(state.m))},
           "roundtrip": sorted(back) ==
           sorted(payload[arch]) and all(back[k].tobytes() ==
                                          payload[arch][k].tobytes()
                                          for k in back)}
    for s, b in enumerate(payload["batches"][arch]):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        params, state, m = step(params, state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["replicated"].append(_replicated(params, mesh, cfg))
        if s == 0:
            full = sharding.gather_train_params(
                params, mesh, cfg=cfg, shapes=SP.param_shapes(cfg))
            out["params1"] = flat_from_params(full)
    return out


def _sc_steps(payload, label):
    return _steps(payload, QWEN, LAYOUTS[label])


def _sc_moe(payload):
    return _steps(payload, PHI, 2)


def _sc_mixer(payload, arch):
    return _steps(payload, arch, 2)


def _cascade(params, cfg, mesh=None):
    batches = _batches(QWEN, 4)
    run = TL.MeshRun(cfg, mesh) if mesh is not None else None

    def loss_fn(p, b, mode):
        return TL.make_loss_fn(cfg, mode=mode, mesh=mesh)(p, b)

    _, hist = TC.train_cascade(
        params, loss_fn,
        lambda s: {k: torch.from_numpy(v) for k, v in batches[s].items()},
        TrainConfig(**TCFG), n_modes=2, steps_per_phase=2, log_every=1,
        verbose=False, donate=True, mesh_run=run)
    return [[r["loss"] for r in ph["log"]] for ph in hist["phases"]]


def _sc_cascade(payload):
    mesh = sharding.train_mesh(2, device="cpu")
    cfg = _cfg(QWEN)
    params = sharding.shard_train_params(
        params_from_flat(payload[QWEN], device="cpu"), mesh, cfg=cfg)
    return _cascade(params, cfg, mesh)


def _sc_forms(payload):
    """Each move in both forms on the world and the model group."""
    mesh = sharding.train_mesh(2, device="cpu")
    r = mesh.rank
    gen = torch.Generator().manual_seed(r)
    f32 = torch.randn((2, 4, 6), generator=gen)
    f32[0, 0, 0], f32[0, 0, 1] = -0.0, float("nan")
    tensors = {"f32": f32, "bf16": f32.to(torch.bfloat16),
               "int8": (f32.nan_to_num() * 40).to(torch.int8)}
    same = {}
    for gname, group in (("world", mesh.group(mesh.axes)),
                         ("model", mesh.group("model"))):
        m = CL.size(group)
        for tname, t in tensors.items():
            a2a = t.reshape(m, -1)
            for op, fn in (
                    ("gather0", lambda f: CL.gather_raw(t, group, 0, form=f)),
                    ("gather2", lambda f: CL.gather_raw(t, group, 2, form=f)),
                    ("all_to_all", lambda f: CL.all_to_all_raw(
                        a2a, group, form=f)),
                    ("ppermute", lambda f: CL.ppermute_raw(
                        t, group, [(i, (i + 1) % m) for i in range(m)],
                        form=f)),
                    ("ppermute_one", lambda f: CL.ppermute_raw(
                        t, group, [(0, m - 1)], form=f))):
                a, b = fn("native"), fn("all_reduce")
                same[(gname, tname, op)] = _bits(a).tobytes() == \
                    _bits(b).tobytes()
        ints = torch.randint(-50, 50, (4 * m, 3), generator=gen).float()
        same[(gname, "f32", "scatter_sum")] = torch.equal(
            CL.scatter_sum_raw(ints, group, 0, form="native"),
            CL.scatter_sum_raw(ints, group, 0, form="all_reduce"))
    # the differentiable pairs' backwards are their transposes
    group = mesh.group(mesh.axes)
    m = CL.size(group)
    x = torch.arange(6.0).reshape(2, 3) + 10 * r
    grads = {}
    for name, fn in (("copy_to", lambda v: CL.copy_to(v, group)),
                     ("reduce_from", lambda v: CL.reduce_from(v, group)),
                     ("all_gather", lambda v: CL.all_gather(v, group, 0)),
                     ("gather_replicated",
                      lambda v: CL.gather_replicated(v, group, 0)),
                     ("reduce_scatter",
                      lambda v: CL.reduce_scatter(v.repeat(m, 1), group, 0)),
                     ("all_to_all", lambda v: CL.all_to_all(
                         v.reshape(1, -1).repeat(m, 1), group)),
                     ("pmean", lambda v: CL.pmean(v.sum(), group))):
        xr = x.clone().requires_grad_(True)
        y = fn(xr)
        w = torch.arange(float(y.numel())).reshape(y.shape) + r
        (g,) = torch.autograd.grad(torch.sum(y * w), xr)
        grads[name] = g.numpy()
    return {"same": same, "grads": grads, "rank": r, "m": m}


def _sc_serve(payload):
    mesh = sharding.serving_mesh(1, 2, device="cpu")
    cfg = _cfg(PHI)
    params = params_from_flat(payload[PHI], device="cpu")
    return _serve(params, cfg, mesh)


def _serve(params, cfg, mesh, serving=TS):
    """Four requests through ``serving``'s continuous engine (the port's,
    or the JAX package's with ``mesh`` None): each request's tokens, wire
    bytes and finishing tick."""
    rng = np.random.default_rng(0)
    reqs = [serving.Request(rid=i, prompt=rng.integers(
        1, cfg.vocab_size, (5 + i % 3,)).astype(np.int32), max_new_tokens=8)
        for i in range(4)]
    eng = serving.ContinuousBatchingEngine(
        params, cfg, n_slots=2, cache_len=48,
        orchestrator=serving.default_orchestrator(cfg),
        **({} if mesh is None else {"mesh": mesh}))
    with eng:
        done = eng.run(reqs)
    return {s.request.rid: (tuple(int(t) for t in s.tokens), s.wire_bytes,
                            s.finished_tick) for s in done}


def _sc_launch(payload):
    from repro_torch.launch import train
    return train.main(LAUNCH + ["--mp", "2", "--ckpt-dir",
                                payload["ckpt_dir"]])


def _sc_launch_fsdp(payload):
    """``launch.train`` on the group's two ranks without --mp: (data 2,
    model 1), FSDP."""
    from repro_torch.launch import train
    return train.main(LAUNCH + ["--ckpt-dir", payload["ckpt_dir_fsdp"]])


def _sc_launch_mixer(payload, arch):
    from repro_torch.launch import train
    return train.main(MIXER_LAUNCH[arch] + MIXER_ARGS + [
        "--mp", "2", "--ckpt-dir", payload["ckpt_dir"]])


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process while the ranks share the
    host's cores with it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    names = {"jax": "jax", "jnp": "jax.numpy", "JSP": "repro.core.split",
             "JL": "repro.training.loop", "JO": "repro.training.optimizer",
             "JC": "repro.core.cascade", "JB": "repro.serving.batcher",
             "JS": "repro.models.sharding", "serving": "repro.serving",
             "ckpt": "repro.training.checkpoint", "jcfg": "repro.configs",
             "jbase": "repro.configs.base"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture(scope="module")
def jparams(ref):
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(ref.jcfg.get_reduced(arch),
                                   dtype="float32")
        out[arch] = ref.JSP.init_split_params(ref.jax.random.PRNGKey(0),
                                              jcfg)
    return out


@pytest.fixture(scope="module")
def payload(ref, jparams, tmp_path_factory):
    out = {a: {k: np.asarray(v) for k, v in ref.ckpt._flatten(p).items()}
           for a, p in jparams.items()}
    out["batches"] = {a: _batches(a) for a in ARCHS}
    out["ckpt_dir"] = str(tmp_path_factory.mktemp("mesh_ckpt"))
    out["ckpt_dir_fsdp"] = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    return out


@pytest.fixture(scope="module")
def world4(payload):
    return torch_ranks.spawn(4, __name__, payload, (
        *((label, "_sc_steps", (label,)) for label in LAYOUTS),
        ("cascade", "_sc_cascade", ()), ("forms", "_sc_forms", ()),
        ("recorded", "_sc_recorded", ()), ("ep_moe", "_sc_ep_moe", ())))


@pytest.fixture(scope="module")
def world2(payload):
    return torch_ranks.spawn(2, __name__, payload, (
        ("moe", "_sc_moe", ()), ("serve", "_sc_serve", ()),
        ("launch", "_sc_launch", ()),
        *((arch, "_sc_mixer", (arch,)) for arch in (RG, XL)),
        ("launch fsdp", "_sc_launch_fsdp", ()),
        *((f"launch {arch}", "_sc_launch_mixer", (arch,))
          for arch in (RG, XL))))


def _one_device(payload, arch):
    """The port's two one-device steps: metrics, the first step's
    parameters and gradients."""
    cfg = _cfg(arch)
    params = params_from_flat(payload[arch], device="cpu")
    step = TL.make_train_step(cfg, TrainConfig(**TCFG), donate=False)
    loss = TL.make_loss_fn(cfg)
    state = TO.init(params)
    out = {"metrics": []}
    for s, b in enumerate(payload["batches"][arch]):
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        if s == 0:
            out["grads"] = flat_from_params(TC.value_and_grad(
                lambda p, bb, _: loss(p, bb), params, batch, None)[1])
            out["params0"] = flat_from_params(params)
        params, state, m = step(params, state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if s == 0:
            out["params1"] = flat_from_params(params)
    return out


@pytest.fixture(scope="module")
def one_device(payload):
    return {a: _one_device(payload, a) for a in ARCHS}


def _jcfg(ref, arch):
    return dataclasses.replace(ref.jcfg.get_reduced(arch), dtype="float32")


@pytest.fixture(scope="module")
def jax_metrics(ref, jparams, payload):
    """The JAX package's two one-device steps of each arch."""
    out = {}
    for arch in ARCHS:
        step = ref.jax.jit(ref.JL.make_train_step(
            _jcfg(ref, arch), ref.jbase.TrainConfig(**TCFG)))
        p, s = jparams[arch], ref.JO.init(jparams[arch])
        out[arch] = []
        for b in payload["batches"][arch]:
            p, s, m = step(p, s, {k: ref.jnp.asarray(v)
                                  for k, v in b.items()})
            out[arch].append({k: float(v) for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def jax_cascade(ref, jparams):
    """The JAX package's ``train_cascade`` on ``_cascade``'s weights,
    batches and arguments: each phase's logged losses."""
    jcfg = _jcfg(ref, QWEN)
    batches = _batches(QWEN, 4)
    _, hist = ref.JC.train_cascade(
        jparams[QWEN],
        lambda p, b, mode: ref.JL.make_loss_fn(jcfg, mode=mode)(p, b),
        lambda s: {k: ref.jnp.asarray(v) for k, v in batches[s].items()},
        ref.jbase.TrainConfig(**TCFG), n_modes=2, steps_per_phase=2,
        log_every=1, verbose=False)
    return [[r["loss"] for r in ph["log"]] for ph in hist["phases"]]


@pytest.fixture(scope="module")
def jax_serve(ref, jparams):
    """The JAX package's one-device continuous engine on phi3.5-moe with
    ``_serve``'s requests. Its paged device loop gets copies of its block
    tables (ROADMAP Queue 3, as in ``tests/test_torch_sharded_serving.py``)."""
    def block_table(self):
        return ref.JS.shard_batch(ref.jnp.asarray(
            self.block_np[:, :self.table_width()].copy()), self.mesh)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref.JB.PagedPool, "block_table", block_table)
        return _serve(jparams[PHI], _jcfg(ref, PHI), None, ref.serving)


def _close(a, b, rel):
    return abs(a - b) <= rel * abs(b) + 1e-6


def _check_steps(world, key, want, jax_metrics=None):
    ranks = [world[r][key] for r in sorted(world)]
    # the ranks' slices gather back to the converted tree bit for bit
    assert all(res["roundtrip"] for res in ranks)
    for s in range(2):
        got = ranks[0]["metrics"][s]
        for ref_m in [want["metrics"][s]] + (
                [jax_metrics[s]] if jax_metrics else []):
            assert _close(got["loss"], ref_m["loss"], LOSS_REL), (s, got)
            assert _close(got["grad_norm"], ref_m["grad_norm"], GRAD_REL)
        for res in ranks:
            assert res["metrics"][s] == got
            assert res["replicated"][s] == ranks[0]["replicated"][s]
    lr = ranks[0]["metrics"][0]["lr"]
    g_all, p0, p1 = want["grads"], want["params0"], want["params1"]
    got = ranks[0]["params1"]
    assert sorted(got) == sorted(p1)
    top = max(float(np.abs(g).max()) for g in g_all.values())
    for k in p1:
        g = g_all.get(k, np.zeros_like(p1[k]))
        big = max(float(np.abs(g).max()), 1e-3 * top)
        small = np.abs(g) < SMALL_G * big
        bound = np.where(small, 2 * lr, STEP_REL * (
            np.abs(p0[k]) + np.abs(p0[k] - p1[k])))
        assert np.all(np.abs(got[k] - p1[k]) <= bound), k
        for res in ranks:
            assert res["params1"][k].tobytes() == got[k].tobytes(), k


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", list(LAYOUTS))
def test_mesh_steps_match_one_device(world4, one_device, jax_metrics,
                                     label):
    _check_steps(world4, label, one_device[QWEN], jax_metrics[QWEN])


def test_moe_over_model_steps_match_one_device(world2, one_device,
                                               jax_metrics):
    _check_steps(world2, "moe", one_device[PHI], jax_metrics[PHI])


@pytest.mark.parametrize("arch", [RG, XL])
def test_mixers_over_model_steps_match_jax(world2, one_device, jax_metrics,
                                           arch):
    """recurrentgemma-2b's RG-LRU channels and xlstm-125m's heads split
    over (data 1, model 2): losses within ``LOSS_REL`` and clipped norms
    within ``GRAD_REL`` of the JAX package's ``make_train_step`` and the
    port's one device, the parameters after a step within the update rule,
    the whole leaves bit-identical across the ranks."""
    _check_steps(world2, arch, one_device[arch], jax_metrics[arch])


def _expected_local(spec, shape, mesh_shape, path):
    """A leaf's local shape under the reference's ``spec`` on
    ``mesh_shape``, the model entries the port keeps whole (outside the
    layers: the embedding, the LM head, the bank) dropped."""
    out = []
    for dim, axis in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = axis if isinstance(axis, tuple) else (axis,)
        n = 1
        for a in axes:
            if a is None or (a == "model" and not path.startswith("layers/")):
                continue
            n *= mesh_shape[a]
        out.append(dim // n)
    return tuple(out)


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_fsdp_local_shapes_match_reference_specs(world4, ref, jparams,
                                                 label):
    """On (data 2, model 2) and (data 4, model 1) each rank's parameter
    leaves and AdamW moments have the shapes the reference's
    ``param_pspecs`` give on an abstract mesh of that shape (its data
    entries applied: FSDP), and the data-split leaves hold a 1/data
    slice."""
    shape = {"data": 4 // LAYOUTS[label], "model": LAYOUTS[label]}
    try:
        amesh = ref.jax.sharding.AbstractMesh(tuple(shape.items()))
    except TypeError:
        amesh = ref.jax.sharding.AbstractMesh(tuple(shape.values()),
                                              tuple(shape))
    specs = ref.JS.param_pspecs(jparams[QWEN], amesh)
    flat = ref.jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, ref.jax.sharding.PartitionSpec)
    )[0]
    want = {ref.JS._path_str(p): s for p, s in flat}
    full = {k: v.shape for k, v in ref.ckpt._flatten(jparams[QWEN]).items()}
    n_fsdp = 0
    for r in world4:
        got = world4[r][label]["shapes"]
        assert sorted(got) == sorted(full)
        for path, (p_shape, m_shape) in got.items():
            exp = _expected_local(want[path], full[path], shape, path)
            assert p_shape == m_shape == exp, (label, r, path, p_shape, exp)
            n_fsdp += "data" in str(want[path]) and p_shape != full[path]
    assert n_fsdp > 0


def test_cascade_on_the_mesh(world4, payload, jax_cascade):
    """Algorithm 1 on the (2, 2) mesh: every logged loss within
    ``LOSS_REL`` of the port's one-device cascade's and of the JAX
    package's ``train_cascade``'s."""
    cfg = _cfg(QWEN)
    one = _cascade(params_from_flat(payload[QWEN], device="cpu"), cfg)
    for want in (one, jax_cascade):
        assert [len(ph) for ph in want] == [2, 2]
        for r in world4:
            got = world4[r]["cascade"]
            assert [len(ph) for ph in got] == [2, 2]
            for gp, wp in zip(got, want):
                for a, b in zip(gp, wp):
                    assert _close(a, b, LOSS_REL), (got, want)


def test_collective_forms_bit_for_bit(world4):
    for r in world4:
        same = world4[r]["forms"]["same"]
        bad = [k for k, ok in same.items() if not ok]
        assert not bad, bad
        assert len(same) == 2 * (3 * 5 + 1)


def test_collective_backwards_are_transposes(world4):
    """Each rank's ``x`` is arange(6) + 10 r as [2, 3]; the loss is
    sum(y * w) with w = arange(y.size) + r on rank r."""
    m = world4[0]["forms"]["m"]
    ws = {r: lambda n, r=r: np.arange(float(n)) + r for r in range(m)}
    for r in world4:
        g = world4[r]["forms"]["grads"]
        w6 = ws[r](6).reshape(2, 3)
        # f: identity forward, the gradients summed
        assert np.array_equal(g["copy_to"], sum(ws[q](6).reshape(2, 3)
                                                for q in range(m)))
        # g: the sum forward, the gradient as it is
        assert np.array_equal(g["reduce_from"], w6)
        # all_gather <-> reduce_scatter: each rank's slice of sum_q w_q
        sl = slice(2 * r, 2 * r + 2)
        assert np.array_equal(g["all_gather"], sum(
            ws[q](6 * m).reshape(2 * m, 3)[sl] for q in range(m)))
        # gather_replicated: this rank's slice of its own w
        assert np.array_equal(g["gather_replicated"],
                              ws[r](6 * m).reshape(2 * m, 3)[sl])
        # reduce_scatter <-> all_gather: every rank's w, summed over the
        # m copies this rank made
        assert np.array_equal(g["reduce_scatter"], sum(
            ws[q](6).reshape(2, 3) for q in range(m)))
        # all_to_all back: row r of each rank q's w, summed over copies
        assert np.array_equal(g["all_to_all"], sum(
            ws[q](6 * m).reshape(m, 6)[r] for q in range(m)).reshape(2, 3))
        # pmean of the sum: 1/m of this rank's weight
        assert np.allclose(g["pmean"], np.full((2, 3), r / m))


def test_moe_serving_over_mp_decodes_one_device_tokens(world2, payload,
                                                       jax_serve):
    cfg = _cfg(PHI)
    want = _serve(params_from_flat(payload[PHI], device="cpu"), cfg, None)
    assert want == jax_serve
    for r in world2:
        assert world2[r]["serve"] == want


@pytest.fixture(scope="module")
def one_launch(tmp_path_factory):
    """The one-device launcher's run of ``LAUNCH``: (its history, the
    directory of its checkpoint)."""
    from repro_torch.launch import train
    ckpt_dir = str(tmp_path_factory.mktemp("one_ckpt"))
    return train.main(LAUNCH + ["--ckpt-dir", ckpt_dir]), ckpt_dir


def test_train_launcher_mp2_checkpoint(world2, payload, ref, one_launch):
    one, tmp_path = one_launch
    got = world2[0]["launch"]
    for a, b in zip(got["phase1"], one["phase1"]):
        assert _close(a["loss"], b["loss"], LAUNCH_LOSS_REL), (got, one)
    assert got["mesh"]["shape"] == {"data": 1, "model": 2}
    assert got["mesh"]["collectives_per_step"]["all_reduce"] > 0
    path = os.path.join(payload["ckpt_dir"], "qwen2_5-3b.npz")
    template = ref.JSP.init_split_params(ref.jax.random.PRNGKey(1),
                                         ref.jcfg.get_reduced(QWEN))
    restored = ref.ckpt.restore(path, template)
    flat = ref.ckpt._flatten(restored)
    mine = ref.ckpt._flatten(ref.ckpt.restore(
        os.path.join(tmp_path, "qwen2_5-3b.npz"), template))
    assert sorted(flat) == sorted(mine)
    for k in flat:
        assert flat[k].shape == mine[k].shape, k
        assert np.all(np.isfinite(np.asarray(flat[k], np.float32))), k


def _restores_in_jax(ref, path):
    template = ref.JSP.init_split_params(ref.jax.random.PRNGKey(1),
                                         ref.jcfg.get_reduced(QWEN))
    flat = ref.ckpt._flatten(ref.ckpt.restore(path, template))
    want = ref.ckpt._flatten(template)
    assert sorted(flat) == sorted(want)
    for k in flat:
        assert flat[k].shape == want[k].shape, k
        assert np.all(np.isfinite(np.asarray(flat[k], np.float32))), k


def test_train_launcher_fsdp_checkpoint(world2, payload, ref, one_launch):
    """``launch.train`` on two ranks without --mp runs (data 2, model 1)
    with the weights and AdamW state split over data: the one-device
    launcher's losses within ``LAUNCH_LOSS_REL``, each rank holding fewer
    parameter and AdamW bytes than the layout without FSDP, and the
    checkpoint rank 0 writes from the gathered slices restores in JAX."""
    one, _ = one_launch
    got = world2[0]["launch fsdp"]
    assert len(got["phase1"]) == len(one["phase1"])
    for a, b in zip(got["phase1"], one["phase1"]):
        assert _close(a["loss"], b["loss"], LAUNCH_LOSS_REL), (got, one)
    mesh = got["mesh"]
    assert mesh["shape"] == {"data": 2, "model": 1}
    for k in ("params", "adam"):
        assert mesh["rank_bytes"][k] < mesh["rank_bytes_unsharded_data"][k]
    _restores_in_jax(ref, os.path.join(payload["ckpt_dir_fsdp"],
                                       "qwen2_5-3b.npz"))


@pytest.mark.parametrize("arch", [RG, XL])
def test_train_launcher_mixers_mp2(world2, arch, tmp_path):
    """``launch.train --mp 2`` of the mixer archs (recurrentgemma-2b under
    Algorithm 1): the one-device launcher's losses within
    ``LAUNCH_LOSS_REL`` on the mesh (data 1, model 2)."""
    from repro_torch.launch import train
    one = train.main(MIXER_LAUNCH[arch] + MIXER_ARGS
                     + ["--ckpt-dir", str(tmp_path)])
    got = world2[0][f"launch {arch}"]
    assert got["mesh"]["shape"] == {"data": 1, "model": 2}
    key = "phases" if arch == RG else "phase1"
    assert len(got[key]) == len(one[key])
    for a, b in zip(got[key], one[key]):
        pairs = (zip(a["log"], b["log"]) if arch == RG else [(a, b)])
        for x, y in pairs:
            assert _close(x["loss"], y["loss"], LAUNCH_LOSS_REL), (got, one)


def test_ranks_load_no_jax(world2, world4):
    for world in (world2, world4):
        for r in world:
            assert world[r]["loaded"] == [], world[r]["loaded"]


# ---------------------------------------------------------------------------
# the collective recorder and the expert-parallel example on the ranks
# ---------------------------------------------------------------------------

def _sc_recorded(payload):
    """One train step of qwen2.5-3b at (data 2, model 2) under the
    collective recorder, with ``collectives.COUNTS`` beside it."""
    from repro_torch.launch import roofline
    mesh = sharding.train_mesh(2, device="cpu")
    cfg = _cfg(QWEN)
    # the converted leaves in the port's init order (the order of a
    # tree's gathers follows its keys), as the dry run builds them
    leaf = dict(sharding._path_leaves(params_from_flat(payload[QWEN],
                                                       device="cpu")))
    params = sharding._map_paths(lambda path, _: leaf[path],
                                 SP.abstract_split_params(cfg))
    params = sharding.shard_train_params(params, mesh, cfg=cfg)
    step = TL.make_train_step(cfg, TrainConfig(**TCFG), mesh=mesh,
                              donate=False)
    batch = {k: torch.from_numpy(v)
             for k, v in payload["batches"][QWEN][0].items()}
    state = TO.init(params)
    CL.reset_counts()
    with roofline.CollectiveRecorder() as rec:
        step(params, state, batch)
    return {"events": rec.events, "summary": rec.summary(),
            "counts": {k: dict(v) for k, v in CL.COUNTS.items()}}


def _sc_ep_moe(payload):
    """The expert-parallel example's ``run`` at (data 2, model 2): both
    runs' losses and the all_to_all moves each issued."""
    from repro_torch.examples import expert_parallel_moe as EX
    mesh = sharding.train_mesh(2, device="cpu")
    cfg = get_reduced(EX.ARCH)
    out = {}
    for ep in (False, True):
        out[ep] = EX.run(cfg, mesh, moe_ep=ep, steps=3, batch=4, seq=16)
    return out



#: the recorder's kind of each op ``collectives.COUNTS`` names
_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "send_recv": "collective-permute"}


def test_recorder_matches_collective_counts(world4):
    first = world4[0]["recorded"]["events"]
    assert first, "the step issued no collective"
    for r in world4:
        rec = world4[r]["recorded"]
        calls, nbytes = rec["counts"]["calls"], rec["counts"]["bytes"]
        assert sum(v["count"] for v in rec["summary"].values()) == \
            sum(calls.values())
        for op, n in calls.items():
            kind = _KIND[op]
            assert rec["summary"][kind]["count"] == n, op
            # COUNTS keeps a reduce-scatter's input buffer, the recorder
            # its result: one group's share of it
            got = sum(b * (g if kind == "reduce-scatter" else 1)
                      for k, g, b in rec["events"] if k == kind)
            assert got == nbytes[op], op
        assert list(rec["events"]) == list(first)


def test_dry_run_records_the_live_step(world4):
    import torch_dry
    out = torch_dry.run_script(f"""
        import dataclasses, json
        from repro_torch.configs import get_reduced
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import dryrun
        cfg = dataclasses.replace(get_reduced("{QWEN}"), dtype="float32")
        sc = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
        print(json.dumps({{r: dryrun.rank_run(
            cfg, sc, {{"data": 2, "model": 2}}, r)["events"]
            for r in (0, 3)}}))
    """)
    for r in (0, 3):
        assert [tuple(e) for e in out[str(r)]] == \
            [tuple(e) for e in world4[r]["recorded"]["events"]]


def test_expert_parallel_example_on_the_mesh(world4):
    for r in world4:
        (ref_losses, ref_a2a), (ep_losses, ep_a2a) = (
            world4[r]["ep_moe"][ep] for ep in (False, True))
        assert ep_a2a > 0 and ref_a2a == 0
        assert max(abs(a - b) for a, b in zip(ref_losses, ep_losses)) < 0.5
        assert ep_losses[-1] < ep_losses[0]
        assert world4[r]["ep_moe"] == world4[0]["ep_moe"]
