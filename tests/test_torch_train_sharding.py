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
  (``shard_train_params``) is the model entry of that leaf's spec;
- the port's layout of every arch (``rank_specs``: what
  ``shard_train_params`` cuts) on (data 2, model 2), (data 4, model 1)
  and (data 1, model 2) is the reference's ``param_pspecs`` leaf by leaf,
  less the model entries of blocks the port keeps whole and plus the
  xLSTM leaves it splits with their heads (``_PORT_RULES``), and the
  rank's slices have the shapes that layout gives;
- the per-block-kind plan (``check_model_parallel``): RG-LRU splits where
  ``d_rnn % m == 0``, the xLSTM mixers where ``n_heads % m == 0``, each
  kind replicated otherwise.
"""
import re
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
    """Each layer leaf the port splits over model (``rank_specs``) is
    split along the model entry of its ``param_pspecs`` spec, and a leaf
    whose spec has a model entry is split wherever its block shards."""
    _, tp = trees[arch]
    cfg = get_reduced(arch)
    specs = _port_specs(sharding.param_pspecs(
        tp, _mesh({"data": 1, "model": model}),
        stacked_layers=cfg.homogeneous))
    blocks = {"attn": sharding.attn_sharded(cfg, model),
              "mlp": sharding.mlp_sharded(cfg, model)}
    port = sharding.rank_specs(cfg, (("model", model),),
                               sharding.tree_shapes(tp))
    for path, leaf in sharding._path_leaves(tp):
        axis = (port[path].index("model") if "model" in port[path]
                else None)
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
    """mp over the RG-LRU and xLSTM mixers no longer raises: the plan is
    per block kind (RG-LRU where ``d_rnn % m == 0``, the xLSTM mixers
    where ``n_heads % m == 0``, each kind replicated otherwise), and the
    rank's config narrows only the kinds that split."""
    from repro_torch.configs import get_config
    cases = [
        # (arch, full?, m): (attn, mlp, rglru, xlstm)
        ("recurrentgemma-2b", False, 2, (False, True, True, False)),
        ("recurrentgemma-2b", False, 3, (False, False, False, False)),
        ("recurrentgemma-2b", True, 2, (False, True, True, False)),
        ("recurrentgemma-2b", True, 4, (False, True, True, False)),
        ("xlstm-125m", False, 2, (False, False, False, True)),
        ("xlstm-125m", False, 4, (False, False, False, False)),
        ("xlstm-125m", True, 4, (False, False, False, True)),
        ("xlstm-125m", True, 8, (False, False, False, False)),
        ("xlstm-125m", True, 1, (False, False, False, False)),
        ("mixtral-8x7b", False, 2, (True, True, False, False)),
    ]
    for arch, full, m, want in cases:
        cfg = get_config(arch) if full else get_reduced(arch)
        got = sharding.check_model_parallel(cfg, m)
        assert got["mlstm"] == got["slstm"]
        assert (got["attn"], got["mlp"], got["rglru"], got["mlstm"]) == \
            want, (arch, full, m, got)
        local = sharding.local_cfg(cfg, m)
        assert local.d_rnn == ((cfg.d_rnn // m) if want[2] else cfg.d_rnn)
        assert local.n_heads == (cfg.n_heads // m if want[0] or want[3]
                                 else cfg.n_heads)
        assert local.head_dim == cfg.head_dim
    with pytest.raises(ValueError):
        sharding.check_model_parallel(get_reduced("xlstm-125m"), 0)


#: the leaves the port splits over model where the reference replicates
#: them (a storage difference: a rank uses only its heads' part)
STORAGE = re.compile(r"mix/(w[if]|w_[ifzo])/b$|mix/r_[ifzo]$")
LAYOUT_SHAPES = ({"data": 2, "model": 2}, {"data": 4, "model": 1},
                 {"data": 1, "model": 2})


@pytest.mark.parametrize("shape", LAYOUT_SHAPES, ids=["d2m2", "d4", "m2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_layout_is_the_reference_spec(trees, arch, shape):
    """The port's layout (``rank_specs``) leaf by leaf is the reference's
    ``param_pspecs`` on an abstract mesh: each data entry (FSDP) kept,
    each model entry kept in a layer whose block kind splits and dropped
    elsewhere (the port keeps the embedding, the LM head, the bank and
    the blocks that do not divide whole over model; an axis of size 1
    splits nothing), plus a model entry on the head axis of the
    ``STORAGE`` leaves where the xLSTM mixers split; the rank's slices
    (``_local_slices``) have those shapes."""
    shapes, tp = trees[arch]
    cfg = get_reduced(arch)
    m = shape["model"]
    splits = sharding.check_model_parallel(cfg, m)
    want = _ref_specs(JS.param_pspecs(shapes, _abstract(shape),
                                      stacked_layers=cfg.homogeneous))
    got = sharding.rank_specs(cfg, tuple(shape.items()),
                              sharding.tree_shapes(tp))
    assert sorted(got) == sorted(want)
    local = dict(sharding._path_leaves(sharding._local_slices(
        tp, cfg, tuple(shape.items()), {"data": 1, "model": m - 1})))
    n_data = 0
    for path, spec in want.items():
        keep = path.startswith("layers/") and splits[
            sharding._layer_kind(path, cfg)]
        exp = tuple(None if (a == "model" and not keep)
                    or shape.get(a) == 1 else a
                    for a in _norm(spec)) + (None,) * (len(got[path])
                                                       - len(spec))
        if STORAGE.search(path) and keep:
            assert "model" not in spec, path
            exp = ("model",) + exp[1:]
        assert _norm(got[path]) == _norm(exp), (path, got[path], exp)
        full = dict(sharding._path_leaves(tp))[path].shape
        div = [shape[a] if a else 1 for a in got[path]]
        assert tuple(local[path].shape) == tuple(
            d // n for d, n in zip(full, div)), path
        n_data += "data" in got[path]
    assert (n_data > 0) == (shape["data"] > 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_are_the_init_tree(trees, arch):
    """``core.split.param_shapes`` (the init run on fake tensors) gives
    each leaf's path, shape and dtype as the real init makes them, in the
    tree's order: the whole tree a rank's layout reads."""
    _, tp = trees[arch]
    assert TSP.param_shapes(get_reduced(arch)) == sharding.tree_shapes(tp)
