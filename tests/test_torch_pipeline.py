"""The port's two-stage pod pipeline (``repro_torch.core.pipeline``) on
four gloo ranks, against the JAX package's one-device ``T.forward`` and
``split_forward`` (the counterpart of ``tests/test_pipeline_pods.py``,
whose (pod 2, data 2, model 2) mesh needs 8 devices).

Reduced stablelm-3b (bf16, the JAX init carried across), tokens [8, 16]
from a numpy seed, ``n_micro`` 4, on (pod 2, data 2, model 1) and (pod 2,
data 1, model 2), each pod rank holding its half of the layers
(``shard_train_params(stages=True)``), with the reference test's bounds:

- the stage and model slices gather back to the whole tree bit for bit
  (``gather_train_params(stages=True)``);
- mode 0 within ``MODE0_ATOL`` of ``T.forward``, mode 1 within
  ``MODE1_ATOL`` of ``split_forward(mode=1)``, every rank of a data row
  with the same logits;
- the gradients of the mode-1 loss reach the layers of both stages and
  the mode's down and up heads; with ``bwd_bits=8`` the layers' gradient
  L1 stays within ``BWD_REL`` of the float backward's;
- the wire counter (``pipeline.WIRE_BYTES``, the counterpart of the
  reference's parse of the compiled collective-permutes) shows mode 1's
  forward bytes under ``WIRE_RATIO`` of mode 0's, and the int8 backward's
  under the float backward's;
- one pipelined train step (``make_train_step(use_pipeline=True)``) gives
  the port's one-device loss within ``STEP_LOSS_REL`` (bf16, mode 0 is
  the monolithic forward) and keeps the replicated leaves (those
  ``split_axes`` leaves whole: on the data-2 layout the LM head and the
  bank are split over data, FSDP) bit-identical across every rank.
"""
import importlib
import types

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.configs import get_reduced
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import params_from_flat
from repro_torch.core import cascade as TC
from repro_torch.core import pipeline as PL
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.training import loop as TL
from repro_torch.training import optimizer as TO

ARCH = "stablelm-3b"
LAYOUTS = {"pod2 data2": (1, 2), "pod2 model2": (2, 2)}   # (model, pod)
N_MICRO = 4
MODE0_ATOL = 0.15
MODE1_ATOL = 0.25
BWD_REL = 0.2
WIRE_RATIO = 0.35
STEP_LOSS_REL = 1e-2
TCFG = dict(learning_rate=1e-3, warmup_steps=2)


def _l1(tree_split):
    """{"split": L1 of the leaves split over model, "whole": of the rest}
    of (gradient, split axes) pairs."""
    out = {"split": 0.0, "whole": 0.0}
    for g, axes in tree_split:
        if g is None:
            continue
        key = "split" if axes and "model" in axes else "whole"
        out[key] += float(torch.sum(torch.abs(g.float())))
    return out


def _bits_of(a):
    return (a.view(torch.int16) if a.dtype == torch.bfloat16
            else a).numpy().tobytes()


def _sc_layout(payload, label):
    model, pod = LAYOUTS[label]
    mesh = sharding.train_mesh(model, pod=pod, device="cpu")
    cfg = get_reduced(ARCH)
    full = params_from_flat(payload["params"], device="cpu")
    local = sharding.shard_train_params(full, mesh, cfg=cfg, stages=True)
    shapes = sharding.tree_shapes(full)
    back = sharding.gather_train_params(local, mesh, cfg=cfg, shapes=shapes,
                                        stages=True)
    roundtrip = all(_bits_of(a) == _bits_of(b) for (_, a), (_, b) in zip(
        sharding._path_leaves(back), sharding._path_leaves(full)))
    run_cfg, plan = mesh.local_cfg(cfg), mesh.rank_plan(cfg, shapes)
    axes = ("data",) if mesh.shape["data"] > 1 else None
    tok = mesh.local_batch({"t": torch.from_numpy(payload["tokens"])},
                           axes)["t"]
    out = {"coords": mesh.coords, "logits": {}, "wire": {}, "grads": {},
           "roundtrip": roundtrip}
    with torch.no_grad():
        for mode in (0, 1):
            PL.reset_wire_bytes()
            lg, _ = PL.pipeline_forward(local, tok, run_cfg, mesh=mesh,
                                        n_micro=N_MICRO, mode=mode,
                                        plan=plan)
            out["logits"][mode] = lg.numpy()
            out["wire"][mode] = dict(PL.WIRE_BYTES)
    split = sharding.split_axes(local, mesh, cfg=cfg, shapes=shapes,
                                stages=True)
    for bwd_bits in (0, 8):
        def loss(p, b, _):
            lg, aux = PL.pipeline_forward(p, b, run_cfg, mesh=mesh,
                                          n_micro=N_MICRO, mode=1,
                                          train=True, bwd_bits=bwd_bits,
                                          plan=plan)
            return T.lm_loss(lg, b) + 0.01 * aux, {}
        PL.reset_wire_bytes()
        _, grads = TC.value_and_grad(loss, local, tok, 1)
        head = grads["bneck_modes"][0]
        out["grads"][bwd_bits] = {
            "layers": _l1(zip(TO.leaves(grads["layers"]),
                              TO._split_leaves(split["layers"]))),
            "down": float(torch.sum(torch.abs(head["down"]["w"].float()))),
            "up": float(torch.sum(torch.abs(head["up"]["w"].float()))),
            "wire": dict(PL.WIRE_BYTES)}
    step = TL.make_train_step(cfg, TrainConfig(**TCFG), mesh=mesh,
                              use_pipeline=True, n_micro=N_MICRO,
                              donate=False)
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    params, _, m = step(local, TO.init(local), batch)
    out["step_loss"] = float(m["loss"])
    out["replicated"] = {
        path: a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
        else a.numpy() for (path, a), (_, axes) in zip(
            sharding._path_leaves(params), sharding._path_leaves(split))
        if not path.startswith("layers/") and axes is None}
    return out


@pytest.fixture(scope="module")
def ref():
    names = {"jax": "jax", "jnp": "jax.numpy", "JSP": "repro.core.split",
             "JT": "repro.models.transformer",
             "ckpt": "repro.training.checkpoint", "jcfg": "repro.configs"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture(scope="module")
def payload(ref):
    from repro_torch.data import tokens as TK
    jcfg = ref.jcfg.get_reduced(ARCH)
    jp = ref.JSP.init_split_params(ref.jax.random.PRNGKey(0), jcfg)
    tok = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (8, 16)).astype(np.int32)
    with ref.jax.default_matmul_precision("highest"):
        ref0, _ = ref.JT.forward(jp, ref.jnp.asarray(tok), jcfg)
        ref1, _, _ = ref.JSP.split_forward(jp, ref.jnp.asarray(tok), jcfg,
                                           mode=1)
    flat = {k: np.asarray(v) for k, v in ref.ckpt._flatten(jp).items()}
    batch = TK.MarkovTokenSource(get_reduced(ARCH), seed=0).batch(8, 16, 0)
    return ({"params": flat, "tokens": tok, "batch": batch},
            {0: np.asarray(ref0, np.float32), 1: np.asarray(ref1, np.float32)})


@pytest.fixture(scope="module")
def world(payload):
    return torch_ranks.spawn(4, __name__, payload[0], tuple(
        (label, "_sc_layout", (label,)) for label in LAYOUTS))


@pytest.fixture(scope="module")
def one_device_loss(payload):
    cfg = get_reduced(ARCH)
    params = params_from_flat(payload[0]["params"], device="cpu")
    step = TL.make_train_step(cfg, TrainConfig(**TCFG), mode=0,
                              donate=False)
    batch = {k: torch.from_numpy(v) for k, v in payload[0]["batch"].items()}
    return float(step(params, TO.init(params), batch)[2]["loss"])


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_pipeline_matches_forward_and_split(payload, world, label):
    """Mode 0 within ``MODE0_ATOL`` of ``T.forward``, mode 1 within
    ``MODE1_ATOL`` of ``split_forward``; each data row's ranks agree."""
    want = payload[1]
    rows = {}
    for r, res in world.items():
        got = res[label]
        assert got["roundtrip"], (label, r)
        i = got["coords"]["data"]
        n = 8 // (2 if label == "pod2 data2" else 1)
        for mode, atol in ((0, MODE0_ATOL), (1, MODE1_ATOL)):
            err = float(np.max(np.abs(got["logits"][mode]
                                      - want[mode][i * n:(i + 1) * n])))
            assert err < atol, (label, r, mode, err)
            first = rows.setdefault((i, mode), got["logits"][mode])
            assert first.tobytes() == got["logits"][mode].tobytes()


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_pipeline_gradients_reach_both_stages(world, label):
    """The mode-1 loss's gradients reach each stage's layers and both
    heads; the int8 backward wire keeps the layers' gradient L1 within
    ``BWD_REL`` of the float backward's."""
    total = {0: 0.0, 8: 0.0}
    for r, res in world.items():
        got = res[label]
        for bits in (0, 8):
            g = got["grads"][bits]
            assert g["layers"]["split"] + g["layers"]["whole"] > 0, \
                (label, r, bits)
            assert g["down"] > 0 and g["up"] > 0, (label, r, bits)
            total[bits] += g["layers"]["split"]
            if got["coords"].get("model", 0) == 0:
                total[bits] += g["layers"]["whole"]
    assert abs(total[0] - total[8]) / total[0] < BWD_REL, total


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_pipeline_wire_bytes(world, label):
    """Mode 1's forward wire moves under ``WIRE_RATIO`` of mode 0's bytes;
    the int8 backward wire fewer than the float one; only stage 0 sends
    forward and only stage 1 backward."""
    sent = {k: 0 for k in ("f0", "f1", "b0", "b8")}
    for r, res in world.items():
        got = res[label]
        stage = got["coords"]["pod"]
        f0, f1 = got["wire"][0]["fwd"], got["wire"][1]["fwd"]
        b0, b8 = (got["grads"][b]["wire"]["bwd"] for b in (0, 8))
        assert (f0 > 0) == (stage == 0) and (b0 > 0) == (stage == 1)
        sent["f0"] += f0
        sent["f1"] += f1
        sent["b0"] += b0
        sent["b8"] += b8
    assert sent["f1"] < WIRE_RATIO * sent["f0"], sent
    assert 0 < sent["b8"] < sent["b0"], sent


@pytest.mark.parametrize("label", list(LAYOUTS))
def test_pipeline_train_step(world, one_device_loss, label):
    """One pipelined train step: the one-device loss within
    ``STEP_LOSS_REL``, the same on every rank, and the replicated leaves
    bit-identical across the ranks."""
    r0 = world[0][label]
    assert abs(r0["step_loss"] - one_device_loss) < \
        STEP_LOSS_REL * abs(one_device_loss)
    for r, res in world.items():
        got = res[label]
        assert got["step_loss"] == r0["step_loss"]
        for path, a in r0["replicated"].items():
            assert got["replicated"][path].tobytes() == a.tobytes(), path


def test_ranks_load_no_jax(world):
    for r in world:
        assert world[r]["loaded"] == [], world[r]["loaded"]
