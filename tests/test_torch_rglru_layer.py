"""The RG-LRU layer's float32 forms made once per loaded model.

The reference promotes the model-dtype gate weights and biases (``w_a``,
``w_x``) and the conv taps to float32 on every call, and recomputes the
constant ``-softplus(-lam)``; the port's serving engines run on a tree
that ``T.prepare_params`` gave those forms once. On reduced
recurrentgemma-2b built from the JAX init through ``repro_torch.convert``:
the prepared layer gives the unprepared layer's bits and stays within the
JAX tolerances of ``tests/test_torch_recurrent.py``; a prepared decode
step casts no gate weight, bias or conv tap (counted under a
``TorchDispatchMode``); the engines prepare their own view and leave the
converted tree as it is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.models import rglru as JRG
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core import split as TSP
from repro_torch.models import rglru as TRG
from repro_torch.models import transformer as TT
from repro_torch.serving import ContinuousBatchingEngine, ServingEngine

ARCH = "recurrentgemma-2b"
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CAST_KEYS = (("w_a", "w"), ("w_a", "b"), ("w_x", "w"), ("w_x", "b"),
             ("conv",))


def _f(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=list(DT))
def model(request):
    dt = request.param
    jcfg = dataclasses.replace(j_reduced(ARCH), dtype=dt)
    tcfg = dataclasses.replace(t_reduced(ARCH), dtype=dt)
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    return dt, jcfg, tcfg, jp, tp


def _rglru_layers(cfg):
    return [i for i in range(cfg.n_layers) if cfg.block_kind(i) == "rglru"]


def _close(dt, got, want, what):
    """As ``tests/test_torch_recurrent.py``: float32 1e-5; bfloat16 two
    ulps of the output's scale (the two frameworks round GeLU and the bf16
    matmuls at different places)."""
    g, w = _f(got), _f(want)
    if dt == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=what)
    else:
        atol = 2.0 ** -7 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=atol,
                                   err_msg=what)


def test_prepared_layer_is_bit_identical(model):
    """``rglru_prefill`` on a ragged batch, then three ``rglru_step``s:
    outputs and carried state equal bit for bit with and without the
    prepared forms, and within the JAX tolerances."""
    dt, jcfg, tcfg, jp, tp = model
    jdt, tdt = DT[dt]
    i = _rglru_layers(tcfg)[0]
    raw = tp["layers"][i]["mix"]
    prep = TRG.rglru_prepare(raw)
    assert "f32" not in raw and TRG.rglru_prepare(prep) is prep
    jl = jp["layers"][i]["mix"]
    B, S, d, dr = 3, 16, tcfg.d_model, tcfg.d_rnn
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    lens = np.array([16, 5, 9], np.int32)
    st = {k: TRG.rglru_state_init(B, dr, dtype=tdt) for k in ("raw", "prep")}
    jst = JRG.rglru_state_init(B, dr, dtype=jdt)
    jy, jst = JRG.rglru_prefill(jl, jnp.asarray(x).astype(jdt), jst,
                                lengths=jnp.asarray(lens))
    ys = {k: TRG.rglru_prefill(p, torch.from_numpy(x).to(tdt), st[k],
                               lengths=torch.from_numpy(lens))
          for k, p in (("raw", raw), ("prep", prep))}
    assert torch.equal(ys["raw"], ys["prep"])
    _close(dt, ys["prep"], jy, "prefill y")
    for step in range(3):
        x1 = rng.standard_normal((B, 1, d)).astype(np.float32)
        jy, jst = JRG.rglru_step(jl, jnp.asarray(x1).astype(jdt), jst)
        ys = {k: TRG.rglru_step(p, torch.from_numpy(x1).to(tdt), st[k])
              for k, p in (("raw", raw), ("prep", prep))}
        assert torch.equal(ys["raw"], ys["prep"]), step
        _close(dt, ys["prep"], jy, f"step {step} y")
        for k in ("h", "conv"):
            assert torch.equal(st["raw"][k], st["prep"][k]), (step, k)
        # the f32 carry follows the bf16-rounded gate inputs in bf16
        _close(dt, st["prep"]["h"], jst["h"], f"step {step} h")


class _OpCounter(TorchDispatchMode):
    """Counts ``aten::_to_copy`` calls by input storage and
    ``aten::softplus`` calls."""

    def __init__(self):
        super().__init__()
        self.casts, self.softplus = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._to_copy.default:
            self.casts.append(args[0].untyped_storage().data_ptr())
        elif func is torch.ops.aten.softplus.default:
            self.softplus += 1
        return func(*args, **(kwargs or {}))


def _gate_storages(params, cfg):
    out = set()
    for i in _rglru_layers(cfg):
        mix = params["layers"][i]["mix"]
        for path in CAST_KEYS:
            t = mix
            for k in path:
                t = t[k]
            out.add(t.untyped_storage().data_ptr())
    return out


def _decode_ops(params, cfg):
    """One mixed-mode decode step of the split model, as the continuous
    engine runs it, under the counter."""
    B, clen = 2, 8
    states = TT.init_decode_state(cfg, B, clen)
    stacked = TB.bank_stack(params["bneck_modes"], cfg.split)
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = torch.tensor([4, 2], dtype=torch.int32)
    modes = torch.tensor([0, 1], dtype=torch.int32)
    with _OpCounter() as ops:
        TSP.split_decode_step_mixed(params, stacked, tok, states, pos, cfg,
                                    modes)
    return ops


def test_prepared_decode_step_casts_no_gate_weight(model):
    """The unprepared step casts each RG-LRU layer's two gate weights, two
    biases and conv taps (bf16) and computes softplus once a layer; the
    prepared step does neither."""
    dt, _, tcfg, _, tp = model
    gates = _gate_storages(tp, tcfg)
    n = len(_rglru_layers(tcfg))
    raw = _decode_ops(tp, tcfg)
    prep = _decode_ops(TT.prepare_params(tp, tcfg), tcfg)
    raw_casts = sum(c in gates for c in raw.casts)
    assert raw_casts == (len(CAST_KEYS) * n if dt == "bfloat16" else 0)
    assert raw.softplus == n
    assert not any(c in gates for c in prep.casts)
    assert prep.softplus == 0
    assert len(raw.casts) - len(prep.casts) == raw_casts


@pytest.mark.parametrize("engine", ["continuous", "sync"])
def test_engines_run_prepared_views(model, engine):
    """Each engine prepares its own view of the tree; the converted tree
    keeps no prepared forms (``convert.py``'s output is unchanged)."""
    _, _, tcfg, _, tp = model
    if engine == "continuous":
        eng = ContinuousBatchingEngine(tp, tcfg, n_slots=2, cache_len=16)
    else:
        eng = ServingEngine(tp, tcfg, cache_len=16, batch=2)
    for i in _rglru_layers(tcfg):
        assert "f32" in eng.params["layers"][i]["mix"]
        assert "f32" not in tp["layers"][i]["mix"]
        assert eng.params["layers"][i]["mix"]["w_a"] is \
            tp["layers"][i]["mix"]["w_a"]
    assert TT.prepare_params(eng.params, tcfg)["layers"][0]["mix"] is \
        eng.params["layers"][0]["mix"]
