"""The port's checkpoints (``repro_torch.training.checkpoint``) against the
JAX package's ``repro.training.checkpoint``, on the CPU: each package
reads the other's files bit for bit (bf16 leaves as a uint16 view, float32
and int leaves as they are, the ``__meta__`` table and metadata), and
``restore`` refuses a file that lacks a leaf (``KeyError``) or holds one
of another shape (``ValueError``), as the reference does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import split as JSP
from repro.training import checkpoint as JC
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import flat_tensors, params_from_flat
from repro_torch.core import split as TSP
from repro_torch.training import checkpoint as TC


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b"])
def test_port_file_restores_in_the_reference(arch, tmp_path):
    """The port's bf16 parameters (tuples of per-layer trees, stacked
    leaves, f32 ``lam``) saved by the port, restored by JAX into the JAX
    package's own tree: every leaf bit for bit."""
    tp = TSP.init_split_params(torch.Generator().manual_seed(3),
                               t_reduced(arch))
    path = str(tmp_path / "port.npz")
    TC.save(path, tp, {"arch": arch, "steps": 7})
    like = JSP.init_split_params(jax.random.PRNGKey(0), j_reduced(arch))
    back = JC._flatten(JC.restore(path, like))
    mine = flat_tensors(tp)
    assert sorted(back) == sorted(mine)
    for k, t in mine.items():
        assert np.asarray(back[k]).dtype.name == str(t.dtype).split(".")[1]
        np.testing.assert_array_equal(_jbits(back[k]), _bits(t))
    assert JC.load_metadata(path) == TC.load_metadata(path) \
        == {"arch": arch, "steps": 7}


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "xlstm-125m"])
def test_reference_file_restores_in_the_port(arch, tmp_path):
    """A JAX checkpoint restored by the port into the port's own tree (the
    template's device, the file's dtypes): every leaf bit for bit."""
    jp = JSP.init_split_params(jax.random.PRNGKey(5), j_reduced(arch))
    path = str(tmp_path / "ref")
    JC.save(path, jp, {"k": 1})
    like = TSP.init_split_params(torch.Generator().manual_seed(0),
                                 t_reduced(arch))
    got = TC.restore(path + ".npz", like)
    assert type(got["layers"]) is type(like["layers"])
    assert type(got["bneck_modes"]) is tuple
    mine = flat_tensors(got)
    want = JC._flatten(jp)
    assert sorted(mine) == sorted(want)
    for k, t in mine.items():
        np.testing.assert_array_equal(_bits(t), _jbits(want[k]))
    assert TC.load_metadata(path) == {"k": 1}


def test_roundtrip_f32_and_ints(tmp_path):
    """Float32 and int32 leaves and a list cross unchanged, in both
    directions."""
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
            "n": [torch.arange(5, dtype=torch.int32),
                  torch.tensor(2.5, dtype=torch.float32)]}
    path = str(tmp_path / "x.npz")
    TC.save(path, tree)
    got = TC.restore(path, tree)
    assert isinstance(got["n"], list)
    for a, b in zip(flat_tensors(tree).values(), flat_tensors(got).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jtree = JC.restore(path, {"a": jnp.zeros((3, 4)),
                              "n": [jnp.zeros(5, jnp.int32), jnp.zeros(())]})
    np.testing.assert_array_equal(np.asarray(jtree["a"]),
                                  tree["a"].numpy())
    assert np.asarray(jtree["n"][0]).dtype == np.int32


def test_restore_refuses_missing_and_misshapen_leaves(tmp_path):
    cfg = t_reduced("qwen2.5-3b")
    p = TSP.init_split_params(torch.Generator().manual_seed(0), cfg)
    path = str(tmp_path / "p.npz")
    TC.save(path, p)
    more = {**p, "extra": {"w": torch.zeros(2)}}
    with pytest.raises(KeyError, match="extra/w"):
        TC.restore(path, more)
    bad = {**p, "final_norm": {"scale": torch.zeros(cfg.d_model + 1)}}
    with pytest.raises(ValueError, match="final_norm/scale"):
        TC.restore(path, bad)
    # the reference refuses the port's file the same way
    jp = JSP.init_split_params(jax.random.PRNGKey(0), j_reduced("qwen2.5-3b"))
    with pytest.raises(KeyError):
        JC.restore(path, {**jp, "extra": {"w": jnp.zeros(2)}})


def test_restored_tree_serves_as_converted_weights(tmp_path):
    """``restore`` of a JAX file gives what ``convert.params_from_flat``
    gives for the same tree: one parameter format across the port."""
    jp = JSP.init_split_params(jax.random.PRNGKey(1),
                               j_reduced("recurrentgemma-2b"))
    path = str(tmp_path / "r.npz")
    JC.save(path, jp)
    like = TSP.init_split_params(torch.Generator().manual_seed(0),
                                 t_reduced("recurrentgemma-2b"))
    a = flat_tensors(TC.restore(path, like))
    b = flat_tensors(params_from_flat(JC._flatten(jp), device="cpu"))
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
               for k in a)
