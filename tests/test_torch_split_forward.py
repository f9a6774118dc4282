"""The port's full-sequence split forward (``split_forward``,
``encoder_apply``, ``decoder_apply``) and ``compression_ratio`` against
the JAX package's, on the CPU.

Reduced qwen2.5-3b and recurrentgemma-2b in float32, weights from the JAX
init carried across by ``repro_torch.convert``, tokens from a seed with
numpy. Modes 0 and 1, eval (int codes on the wire) and train (the
straight-through fake-quantized code). Tolerance: logits within 1e-4 of
JAX's (f32 sums in two orders through a few layers); mode 1's int8 wire
codes equal and its scales within 1e-6 relative (a code one step apart,
where z / scale sits on a rounding edge, would fail the check rather than
hide in the logits' tolerance). Payload bytes and compression ratios are
equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import bottleneck as JB
from repro.core import split as JSP
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core import split as TSP
from repro_torch.models import transformer as TT

LOGITS_ABS = 1e-4


@pytest.fixture(scope="module", params=["qwen2.5-3b", "recurrentgemma-2b"])
def model(request):
    arch = request.param
    jcfg = dataclasses.replace(j_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(t_reduced(arch), dtype="float32")
    jp = JSP.init_split_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    tok = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 16),
                                            dtype=np.int32)
    return jcfg, tcfg, jp, tp, tok


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("mode", [0, 1])
def test_split_forward_matches_reference(model, mode, train):
    jcfg, tcfg, jp, tp, tok = model
    want, jaux, jinfo = JSP.split_forward(jp, jnp.asarray(tok), jcfg, mode,
                                          train=train)
    with torch.no_grad():
        got, aux, info = TSP.split_forward(tp, torch.from_numpy(tok), tcfg,
                                           mode, train=train)
    assert info["payload_bytes"] == jinfo["payload_bytes"]
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_array_equal(info["positions"].numpy(),
                                  np.asarray(jinfo["positions"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_ABS)


def test_encoder_payload_matches_reference(model):
    """Mode 1 in eval: the int8 codes and the scales that cross the wire
    are the reference's; the decoder from the same payload gives its
    logits."""
    jcfg, tcfg, jp, tp, tok = model
    (jc, js), _, _ = JSP.encoder_apply(jp, jnp.asarray(tok), jcfg, 1)
    with torch.no_grad():
        (codes, scales), _, info = TSP.encoder_apply(
            tp, torch.from_numpy(tok), tcfg, 1)
        assert codes.dtype == torch.int8 and scales.dtype == torch.float32
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_allclose(scales.numpy(), np.asarray(js), rtol=1e-6)
        got, _ = TSP.decoder_apply(
            tp, (codes, torch.from_numpy(np.array(js))), info["positions"],
            tcfg, 1)
    want, _ = JSP.decoder_apply(jp, (jc, js), jnp.asarray(info["positions"]
                                                          .numpy()), jcfg, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGITS_ABS)


def test_split_mode0_equals_full_forward(model):
    """The reference's ``test_split_mode0_equals_full_forward`` on the port:
    mode 0 is the full model's forward, and its payload is the raw bf16
    boundary activation's bytes."""
    _, tcfg, _, tp, tok = model
    with torch.no_grad():
        full, _ = TT.forward(tp, torch.from_numpy(tok), tcfg)
        split, _, info = TSP.split_forward(tp, torch.from_numpy(tok), tcfg,
                                           mode=0)
    assert torch.equal(split, full)
    assert info["payload_bytes"] == 2 * 16 * tcfg.d_model * 2


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "xlstm-125m", "granite-8b"])
def test_compression_ratio_matches_reference(arch):
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    for mode in range(tcfg.split.n_modes):
        assert TB.compression_ratio(tcfg, mode) \
            == JB.compression_ratio(jcfg, mode)
    assert TB.compression_ratio(tcfg, 1) < 0.3


def test_ste_gradient_reaches_layer_a(model):
    """Mode 1 under ``train``: the straight-through code lets the loss's
    gradient reach the bank's down-projection (layer A)."""
    _, tcfg, _, tp, tok = model
    w = tp["bneck_modes"][0]["down"]["w"].clone().requires_grad_(True)
    p = {**tp, "bneck_modes": ({**tp["bneck_modes"][0],
                                "down": {"w": w}},)}
    logits, _, _ = TSP.split_forward(p, torch.from_numpy(tok), tcfg, 1,
                                     train=True)
    (g,) = torch.autograd.grad(
        TT.lm_loss(logits, torch.from_numpy(tok).long()), w)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
