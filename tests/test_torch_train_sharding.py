"""The training half of the port's ``models.sharding`` against the JAX
package's ``repro.models.sharding``, spec by spec, with no ranks: a spec
is a plain tuple in the port and a ``PartitionSpec`` (a tuple) in the
reference, computed from a mesh's axis sizes (a
``jax.sharding.AbstractMesh`` there, any object with a ``shape`` here).

- ``param_pspecs`` leaf by leaf for every arch's reduced split parameters
  (the JAX init's shapes; the port's own init) at (data 2, model 2) and
  (pod 2, data 2, model 2), ``stacked_layers`` True and False,
  ``tp_scope`` "all" and "ffn";
- the counterparts of ``tests/test_act_policies.py``'s four tests
  (``batch_pspec``, ``default_activation_rules``, the ffn scope,
  ``ctx_mesh`` / ``ctx_flag``);
- ``state_pspecs`` of every arch's decode state (int8 caches too) at two
  batch sizes;
- ``moe_supports_ep`` on the reference test's cases and meshes;
- the model axis the port splits each layer leaf over
  (``shard_train_params``) is the model entry of that leaf's spec.
"""
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.models import moe_ep as JEP
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro_torch.configs import ARCH_IDS, get_reduced
from repro_torch.core import split as TSP
from repro_torch.models import moe_ep, sharding
from repro_torch.models import transformer as T

SHAPES = ({"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2})


def _abstract(shape):
    try:
        return jax.sharding.AbstractMesh(tuple(shape.items()))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(shape.values()),
                                         tuple(shape))


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _norm(spec):
    """A spec with each one-axis tuple written as its axis (how the
    reference's ``PartitionSpec`` reads back under newer JAX)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _is_spec(x):
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


def _spec_leaves(tree, prefix=""):
    """(path, spec) of a tree of specs (a spec is a tuple; so is a
    heterogeneous stack of layer trees)."""
    if _is_spec(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{prefix}/{i}" if prefix else str(i))


def _port_specs(specs):
    return {k: _norm(v) for k, v in _spec_leaves(specs)}


def _ref_specs(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {JS._path_str(p): _norm(tuple(s)) for p, s in flat}


@pytest.fixture(scope="module")
def trees():
    """Each arch's reduced split parameters: (JAX shapes, port tensors)."""
    out = {}
    for arch in ARCH_IDS:
        jcfg = j_reduced(arch)
        shapes = jax.eval_shape(lambda k, c=jcfg: JSP.init_split_params(
            k, c), jax.random.PRNGKey(0))
        tp = TSP.init_split_params(torch.Generator().manual_seed(0),
                                   get_reduced(arch))
        out[arch] = (shapes, tp)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=["dm", "pdm"])
@pytest.mark.parametrize("tp_scope", ["all", "ffn"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(trees, arch, tp_scope, shape):
    shapes, tp = trees[arch]
    for stacked in (True, False):
        want = _ref_specs(JS.param_pspecs(shapes, _abstract(shape),
                                          stacked_layers=stacked,
                                          tp_scope=tp_scope))
        got = _port_specs(sharding.param_pspecs(tp, _mesh(shape),
                                                stacked_layers=stacked,
                                                tp_scope=tp_scope))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == want[k], (k, stacked, got[k], want[k])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "phi3.5-moe-42b-a6.6b",
                                  "stablelm-3b", "mixtral-8x7b"])
@pytest.mark.parametrize("model", [2, 4])
def test_split_axis_is_the_specs_model_entry(trees, arch, model):
    """Each layer leaf the port splits (``_model_axis``) is split along
    the model entry of its ``param_pspecs`` spec, and a leaf whose spec
    has a model entry is split wherever its block shards."""
    _, tp = trees[arch]
    cfg = get_reduced(arch)
    specs = _port_specs(sharding.param_pspecs(
        tp, _mesh({"data": 1, "model": model}),
        stacked_layers=cfg.homogeneous))
    blocks = {"attn": sharding.attn_sharded(cfg, model),
              "mlp": sharding.mlp_sharded(cfg, model)}
    for path, leaf in sharding._path_leaves(tp):
        axis = sharding._model_axis(path, leaf.dim(), cfg, model)
        spec = specs[path]
        block = "attn" if "mix/" in path else "mlp"
        if path.startswith("layers/") and "model" in spec and blocks[block]:
            assert axis == spec.index("model"), path
        else:
            assert axis is None, path


def test_batch_pspec_policies():
    m = _mesh({"data": 2, "model": 2})
    assert sharding.batch_pspec(m, 2, 8) == (("data",), None)
    assert sharding.batch_pspec(m, 2, 8, "batch2d") == \
        (("data", "model"), None)
    assert sharding.batch_pspec(m, 2, 2, "batch2d") == (("data",), None)
    assert sharding.batch_pspec(m, 2, 1) == (None, None)
    for pm in (_mesh({"pod": 2, "data": 2, "model": 2}), m):
        apm = _abstract(pm.shape)
        for b in (1, 2, 4, 6, 8, 16):
            for pol in ("seq", "batch", "batch2d"):
                assert _norm(sharding.batch_pspec(pm, 3, b, pol)) == _norm(
                    tuple(JS.batch_pspec(apm, 3, b, pol))), (pm.shape, b,
                                                             pol)


def test_activation_rules_policies():
    m = _mesh({"data": 2, "model": 2})
    seq = sharding.default_activation_rules(m, act_policy="seq")
    assert seq["resid"] == (("data",), "model", None)
    batch = sharding.default_activation_rules(m, act_policy="batch")
    assert batch["resid"] == (("data",), None, None)
    b2 = sharding.default_activation_rules(m, act_policy="batch2d")
    assert b2["resid"] == (("data", "model"), None, None)
    with pytest.raises(ValueError):
        sharding.default_activation_rules(m, act_policy="nope")
    ep = sharding.default_activation_rules(m, act_policy="batch2d",
                                           moe_ep=True)
    assert ep["moe_ep"] is True
    for shape in SHAPES:
        for kw in ({"act_policy": "seq"}, {"act_policy": "batch"},
                   {"act_policy": "batch2d", "moe_ep": True},
                   {"seq_shard": False}, {}):
            want = JS.default_activation_rules(_abstract(shape), **kw)
            got = sharding.default_activation_rules(_mesh(shape), **kw)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert (got[k] if isinstance(v, bool) else _norm(got[k])) \
                    == (v if isinstance(v, bool) else _norm(tuple(v)))


def test_tp_scope_ffn_strips_model_from_attention(trees):
    _, tp = trees["stablelm-3b"]
    cfg = get_reduced("stablelm-3b")
    m = _mesh({"data": 2, "model": 2})
    full = _port_specs(sharding.param_pspecs(tp, m,
                                             stacked_layers=cfg.homogeneous))
    ffn = _port_specs(sharding.param_pspecs(
        tp, m, stacked_layers=cfg.homogeneous, tp_scope="ffn"))
    saw_attn = saw_mlp = False
    for name, spec in ffn.items():
        if "mix/" in name:
            assert "model" not in spec, name
            saw_attn = True
        if "mlp/" in name:
            assert spec == full[name]
            saw_mlp = True
    assert saw_attn and saw_mlp


def test_ctx_flag_roundtrip():
    m = _mesh({"data": 2, "model": 2})
    assert sharding.ctx_mesh() is None
    assert not sharding.ctx_flag("moe_ep")
    with sharding.activation_rules(m, {"moe_ep": True, "batch": 8}):
        assert sharding.ctx_mesh() is m
        assert sharding.ctx_flag("moe_ep")
        assert sharding.ctx_rule("batch") == 8
    assert sharding.ctx_mesh() is None
    assert sharding.ctx_rule("batch", 3) == 3


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_state_pspecs_match_reference(arch, kv_bits):
    jcfg, cfg = j_reduced(arch), get_reduced(arch)
    jstate = jax.eval_shape(lambda: JT.init_decode_state(jcfg, 4, 16,
                                                         kv_bits=kv_bits))
    tstate = T.init_decode_state(cfg, 4, 16, device="meta", kv_bits=kv_bits)
    for shape in SHAPES:
        for batch in (4, 3):
            want = _ref_specs(JS.state_pspecs(jstate, _abstract(shape),
                                              batch,
                                              stacked=cfg.homogeneous))
            got = _port_specs(sharding.state_pspecs(
                tstate, _mesh(shape), batch, stacked=cfg.homogeneous))
            assert got == want, (arch, shape, batch)


def test_moe_supports_ep_matches_reference():
    """The reference test's cases on its (data 2, model 4) mesh, and more
    on (pod 2, data 2, model 2) and without a model axis."""
    m = _mesh({"data": 2, "model": 4})
    assert moe_ep.moe_supports_ep(4, m, 8, 16)
    assert not moe_ep.moe_supports_ep(3, m, 8, 16)
    assert moe_ep.moe_supports_ep(4, m, 6, 16)
    assert not moe_ep.moe_supports_ep(4, m, 5, 16)
    assert not moe_ep.moe_supports_ep(4, m, 8, 6)
    assert not moe_ep.moe_supports_ep(4, None, 8, 16)
    for shape in ({"data": 2, "model": 4}, SHAPES[1], {"data": 4}):
        for e in (3, 4, 8, 16):
            for b in (1, 4, 6, 8):
                for s in (6, 8, 16):
                    assert moe_ep.moe_supports_ep(e, _mesh(shape), b, s) \
                        == JEP.moe_supports_ep(e, _abstract(shape), b, s)


def test_mp_over_recurrent_mixers_raises_naming_7c():
    for arch in ("recurrentgemma-2b", "xlstm-125m"):
        with pytest.raises(NotImplementedError, match="item 7c"):
            sharding.check_model_parallel(get_reduced(arch), 2)
    sharding.check_model_parallel(get_reduced("mixtral-8x7b"), 2)
    sharding.check_model_parallel(get_reduced("xlstm-125m"), 1)
