"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) on four
gloo ranks, a (data 2, model 2) ``TrainMesh``, against the JAX package's
``moe_apply`` and its per-chip routing ``moe_ep._route_local`` (the
counterpart of ``tests/test_moe_ep.py``, whose mesh is (data 2, model 4)).

In float32, d 32, f 64, E 4, k 2, x [8, 16, d] from a numpy seed, the
weights from JAX's ``moe_init``:

- at ``capacity_factor`` 8 (no token drops) each rank's output rows equal
  the reference's within ``Y_ATOL`` and every gradient of sum(y^2) (the
  tokens', the router's, each rank's experts', summed over the dp ranks
  as the train step averages them) within ``GRAD_ATOL``: the reference
  test's bounds;
- at capacity 1.0 each rank's block routes as the reference's
  ``_route_local`` on the same block: experts, slots and kept choices
  equal, gates within ``GATE_ATOL`` (the router product and softmax in
  another summation order), the aux loss within ``AUX_ATOL``; the tokens
  that lose every choice are the rows the layer leaves zero, exactly;
- the aux loss, averaged over the model ranks by the layer and over the
  dp ranks here (as the train step does), is the mean of the reference's
  per-chip terms;
- one train step of reduced phi3.5-moe with ``moe_ep=True`` runs the
  expert-parallel layer, keeps the replicated leaves bit-identical across
  the ranks, and its loss is finite.
"""
import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.configs import get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import params_from_flat
from repro_torch.core import split as SP
from repro_torch.data import tokens as TK
from repro_torch.models import moe_ep, sharding
from repro_torch.models import transformer as T
from repro_torch.training import loop as TL
from repro_torch.training import optimizer as TO

D, F, E, K = 32, 64, 4, 2
B, S = 8, 16
Y_ATOL = 1e-5
GRAD_ATOL = 1e-3
GATE_ATOL = 1e-6
AUX_ATOL = 1e-6
ARCH = "phi3.5-moe-42b-a6.6b"


def _layer(flat):
    return params_from_flat({k: v for k, v in flat.items()}, device="cpu")


def _rank_layer(p, m):
    """The rank's experts (E / 2 of them) and the whole router."""
    n = E // 2
    return {"router": p["router"],
            **{k: p[k][m * n:(m + 1) * n].clone()
               for k in ("w_gate", "w_up", "w_down")}}


def _sc_ep(payload):
    mesh = sharding.train_mesh(2, device="cpu")
    i, m = mesh.coords["data"], mesh.coords["model"]
    p = _rank_layer(_layer(payload["layer"]), m)
    out = {"coords": (i, m)}
    x = torch.from_numpy(payload["x"][i * B // 2:(i + 1) * B // 2])
    for cf in (8.0, 1.0):
        xl = x.clone().requires_grad_(True)
        leaves = [p["router"]["w"], p["w_gate"], p["w_up"], p["w_down"]]
        req = [a.detach().requires_grad_(True) for a in leaves]
        pl = {"router": {"w": req[0]}, "w_gate": req[1], "w_up": req[2],
              "w_down": req[3]}
        y, aux = moe_ep.moe_apply_ep(pl, xl, k=K, capacity_factor=cf,
                                     mesh=mesh)
        grads = torch.autograd.grad(torch.sum(y ** 2), [xl] + req)
        out[cf] = {"y": y.detach().numpy(), "aux": float(aux),
                   "grads": [g.numpy() for g in grads]}
    s_loc = S // 2
    xb = x[:, m * s_loc:(m + 1) * s_loc].reshape(-1, D)
    cap = max(int(1.0 * K * xb.shape[0] / E), 1)
    gates, idx, slot, keep, aux = moe_ep._route_local(
        p["router"]["w"], xb, K, cap, E)
    out["route"] = {"gates": gates.numpy(), "idx": idx.numpy(),
                    "slot": slot.numpy(), "keep": keep.numpy(),
                    "aux": float(aux), "cap": cap}
    return out


def _sc_train(payload):
    """One train step of reduced phi3.5-moe with moe_ep=True."""
    mesh = sharding.train_mesh(2, device="cpu")
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="float32")
    full = params_from_flat(payload["model"], device="cpu")
    params = sharding.shard_train_params(full, mesh, cfg=cfg)
    calls = []
    orig = moe_ep.moe_apply_ep

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    T.moe_apply_ep = counted
    try:
        step = TL.make_train_step(cfg, TrainConfig(learning_rate=1e-3,
                                                   warmup_steps=2),
                                  mesh=mesh, moe_ep=True, donate=False)
        batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
        params, _, m = step(params, TO.init(params), batch)
    finally:
        T.moe_apply_ep = orig
    split = sharding.split_axes(params, mesh, cfg=cfg,
                                shapes=SP.param_shapes(cfg))
    rep = {path: a.numpy() for (path, a), (_, s) in zip(
        sharding._path_leaves(params), sharding._path_leaves(split))
        if s is None}
    return {"loss": float(m["loss"]), "ep_calls": len(calls),
            "replicated": rep}


@pytest.fixture(scope="module")
def ref():
    names = {"jax": "jax", "jnp": "jax.numpy", "moe": "repro.models.moe",
             "moe_ep": "repro.models.moe_ep", "ckpt":
             "repro.training.checkpoint", "JSP": "repro.core.split",
             "jcfg": "repro.configs"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture(scope="module")
def payload(ref):
    p = ref.moe.moe_init(ref.jax.random.PRNGKey(0), D, F, E,
                         dtype=ref.jnp.float32)
    x = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    jcfg = dataclasses.replace(ref.jcfg.get_reduced(ARCH), dtype="float32")
    jp = ref.JSP.init_split_params(ref.jax.random.PRNGKey(0), jcfg)
    src = TK.MarkovTokenSource(get_reduced(ARCH), seed=0)
    return {"layer": {k: np.asarray(v)
                      for k, v in ref.ckpt._flatten(p).items()},
            "x": x, "jp": p,
            "model": {k: np.asarray(v)
                      for k, v in ref.ckpt._flatten(jp).items()},
            "batch": src.batch(4, 16, 0)}


@pytest.fixture(scope="module")
def world(payload):
    send = {k: payload[k] for k in ("layer", "x", "model", "batch")}
    return torch_ranks.spawn(4, __name__, send, (
        ("ep", "_sc_ep", ()), ("train", "_sc_train", ())))


def _jax_grads(ref, p, x, cf):
    jnp = ref.jnp

    def loss(p, x):
        y, _ = ref.moe.moe_apply(p, x, k=K, capacity_factor=cf)
        return jnp.sum(y ** 2)
    with ref.jax.default_matmul_precision("highest"):
        y, aux = ref.moe.moe_apply(p, jnp.asarray(x), k=K,
                                   capacity_factor=cf)
        gp, gx = ref.jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    return np.asarray(y), float(aux), gp, np.asarray(gx)


def test_moe_ep_matches_moe_apply(ref, payload, world):
    """Forward within ``Y_ATOL`` and every gradient within ``GRAD_ATOL``
    of the reference's at capacity factor 8."""
    y, _, gp, gx = _jax_grads(ref, payload["jp"], payload["x"], 8.0)
    half = B // 2
    router = np.zeros_like(np.asarray(gp["router"]["w"]))
    experts = {m: [0, 0, 0] for m in (0, 1)}
    for r, res in world.items():
        i, m = res["ep"]["coords"]
        got = res["ep"][8.0]
        assert np.max(np.abs(got["y"] - y[i * half:(i + 1) * half])) \
            < Y_ATOL
        gxl, grw, ggate, gup, gdown = got["grads"]
        assert np.max(np.abs(gxl - gx[i * half:(i + 1) * half])) \
            < GRAD_ATOL
        if m == 0:
            router += grw
        for j, g in enumerate((ggate, gup, gdown)):
            experts[m][j] = experts[m][j] + g
    assert np.max(np.abs(router - np.asarray(gp["router"]["w"]))) \
        < GRAD_ATOL
    n = E // 2
    for m in (0, 1):
        for j, name in enumerate(("w_gate", "w_up", "w_down")):
            want = np.asarray(gp[name])[m * n:(m + 1) * n]
            assert np.max(np.abs(experts[m][j] - want)) < GRAD_ATOL, name


def test_moe_ep_routes_each_block_as_the_reference(ref, payload, world):
    """Capacity 1.0: each rank's block routed as the reference's
    ``_route_local`` routes it, and the tokens that lose every choice are
    exactly the zero rows of the layer's output."""
    x, jp = payload["x"], payload["jp"]
    half, s_loc = B // 2, S // 2
    auxes = []
    for r, res in world.items():
        i, m = res["ep"]["coords"]
        got = res["ep"]["route"]
        xb = x[i * half:(i + 1) * half, m * s_loc:(m + 1) * s_loc]
        with ref.jax.default_matmul_precision("highest"):
            gates, idx, slot, keep, aux = ref.moe_ep._route_local(
                jp["router"]["w"], ref.jnp.asarray(xb.reshape(-1, D)), K,
                got["cap"], E)
        np.testing.assert_array_equal(got["idx"], np.asarray(idx))
        np.testing.assert_array_equal(got["slot"], np.asarray(slot))
        np.testing.assert_array_equal(got["keep"], np.asarray(keep))
        assert np.max(np.abs(got["gates"] - np.asarray(gates))) < GATE_ATOL
        assert abs(got["aux"] - float(aux)) < AUX_ATOL
        auxes.append(float(aux))
        y = res["ep"][1.0]["y"][:, m * s_loc:(m + 1) * s_loc].reshape(-1, D)
        zero = np.all(y == 0.0, axis=-1)
        np.testing.assert_array_equal(zero, ~np.asarray(keep).any(-1))
        assert np.all(np.isfinite(res["ep"][1.0]["y"]))
    # the layer's aux: the model mean; the dp mean of it, the chips' mean
    dp_mean = np.mean([world[r]["ep"][1.0]["aux"] for r in world])
    assert abs(dp_mean - np.mean(auxes)) < AUX_ATOL


def test_moe_ep_train_step(world):
    """A train step with moe_ep=True runs the expert-parallel layer (each
    MoE layer once a forward and once a recomputation), its loss is finite
    and the replicated leaves are bit-identical on every rank."""
    cfg = get_reduced(ARCH)
    r0 = world[0]["train"]
    assert r0["ep_calls"] == 2 * cfg.n_layers
    assert np.isfinite(r0["loss"])
    for r in world:
        got = world[r]["train"]
        assert got["loss"] == r0["loss"]
        for path, a in r0["replicated"].items():
            assert got["replicated"][path].tobytes() == a.tobytes(), path


def test_ranks_load_no_jax(world):
    for r in world:
        assert world[r]["loaded"] == [], world[r]["loaded"]
