"""The port's quantized tensor-parallel prefill (``repro_torch.core.qtp``)
on four gloo ranks, a (data 2, model 2) ``TrainMesh``, against the JAX
package's ``T.forward`` (the counterpart of ``tests/test_qtp.py``, whose
mesh is (data 2, model 4): there granite-8b's two KV heads do not divide
the model axis and only stablelm-3b runs; at model 2 both do).

Reduced stablelm-3b and granite-8b (bf16, the JAX init carried across),
tokens [8, 32] from a numpy seed, the reference test's bounds: ``bits=0``
within ``BITS0_ATOL`` of the monolithic logits, ``bits=8`` within
``BITS8_REL`` relative norm, and bits 8 differing from bits 0 by more
than ``BITS_DIFFER`` (the int8 gather must act). The absolute bound was
set on stablelm-3b's logits (|logit| <= 4.4 here); granite-8b's reach
147, where a bf16 rounding of the residual carried to the head moves a
logit by more: the JAX package's own ``qtp_forward`` at (data 2, model 2)
is 0.153 off its monolithic forward on these inputs. So ``bits=0`` is
held to the larger of ``BITS0_ATOL`` and ``BITS0_SCALE`` of the largest
|logit| (0.287 on granite-8b, 0.1 on stablelm-3b). Every rank returns the
same logits. The guard refuses qwen2.5-3b (two KV heads on a 4-wide axis)
and mixtral-8x7b (MoE), as the reference's does.
"""
import importlib
import types

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import qtp
from repro_torch.models import sharding

ARCHS = ("stablelm-3b", "granite-8b")
BITS0_ATOL = 0.1
BITS0_SCALE = 2.0 ** -9
BITS8_REL = 0.05
BITS_DIFFER = 1e-6
TOKENS = (8, 32)


def _sc_qtp(payload):
    mesh = sharding.train_mesh(2, device="cpu")
    out = {}
    for arch in ARCHS:
        cfg = get_reduced(arch)
        assert qtp.qtp_supported(cfg, mesh, TOKENS[1])
        full = params_from_flat(payload[arch], device="cpu")
        local = sharding.shard_train_params(full, mesh, cfg=cfg)
        tok = torch.from_numpy(payload["tokens"])
        out[arch] = {bits: qtp.qtp_forward(local, tok, cfg, mesh=mesh,
                                           bits=bits).numpy()
                     for bits in (0, 8)}
    return out


@pytest.fixture(scope="module")
def ref():
    names = {"jax": "jax", "jnp": "jax.numpy", "JSP": "repro.core.split",
             "JT": "repro.models.transformer", "JQ": "repro.core.qtp",
             "ckpt": "repro.training.checkpoint", "jcfg": "repro.configs"}
    return types.SimpleNamespace(**{k: importlib.import_module(v)
                                    for k, v in names.items()})


@pytest.fixture(scope="module")
def payload(ref):
    out = {"tokens": np.random.default_rng(1).integers(
        0, get_reduced(ARCHS[0]).vocab_size, TOKENS).astype(np.int32)}
    refs = {}
    for arch in ARCHS:
        jcfg = ref.jcfg.get_reduced(arch)
        jp = ref.JSP.init_split_params(ref.jax.random.PRNGKey(0), jcfg)
        out[arch] = {k: np.asarray(v)
                     for k, v in ref.ckpt._flatten(jp).items()}
        with ref.jax.default_matmul_precision("highest"):
            lg, _ = ref.JT.forward(jp, ref.jnp.asarray(out["tokens"]), jcfg)
        refs[arch] = np.asarray(lg, np.float32)
    return out, refs


@pytest.fixture(scope="module")
def world(payload):
    return torch_ranks.spawn(4, __name__, payload[0],
                             (("qtp", "_sc_qtp", ()),))


@pytest.mark.parametrize("arch", ARCHS)
def test_qtp_matches_monolithic_forward(payload, world, arch):
    want = payload[1][arch]
    lg0, lg8 = world[0]["qtp"][arch][0], world[0]["qtp"][arch][8]
    for r in world:
        for bits in (0, 8):
            assert world[r]["qtp"][arch][bits].tobytes() == \
                world[0]["qtp"][arch][bits].tobytes(), (r, bits)
    err0 = float(np.max(np.abs(lg0 - want)))
    assert err0 < max(BITS0_ATOL, BITS0_SCALE * np.max(np.abs(want))), err0
    rel8 = float(np.linalg.norm(lg8 - want) / np.linalg.norm(want))
    assert rel8 < BITS8_REL, rel8
    assert float(np.max(np.abs(lg8 - lg0))) > BITS_DIFFER


def _abstract(ref, shape):
    """A ``jax.sharding.AbstractMesh`` of ``shape`` in either signature."""
    try:
        return ref.jax.sharding.AbstractMesh(tuple(shape.items()))
    except TypeError:
        return ref.jax.sharding.AbstractMesh(tuple(shape.values()),
                                             tuple(shape))


def test_qtp_guard_matches_the_reference(ref):
    """``qtp_supported`` on the reference test's mesh (data 2, model 4)
    and on (data 2, model 2), every reduced arch and sequence 32 / 30, as
    the reference's."""
    from repro_torch.configs import ARCH_IDS
    for shape in ({"data": 2, "model": 4}, {"data": 2, "model": 2}):
        mesh = types.SimpleNamespace(shape=shape)
        jmesh = _abstract(ref, shape)
        for arch in ARCH_IDS:
            for seq in (32, 30):
                assert qtp.qtp_supported(get_reduced(arch), mesh, seq) == \
                    ref.JQ.qtp_supported(ref.jcfg.get_reduced(arch), jmesh,
                                         seq), (arch, shape, seq)
    m4 = types.SimpleNamespace(shape={"data": 2, "model": 4})
    assert not qtp.qtp_supported(get_reduced("qwen2.5-3b"), m4, 32)
    assert not qtp.qtp_supported(get_reduced("mixtral-8x7b"), m4, 32)
    assert not qtp.qtp_supported(get_reduced("qwen2.5-3b"), None, 32)


def test_ranks_load_no_jax(world):
    for r in world:
        assert world[r]["loaded"] == [], world[r]["loaded"]
