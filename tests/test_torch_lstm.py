"""The port's paper LSTM (``repro_torch.models.lstm``), its straight-through
quantizer and the bottleneck's training encode against the JAX package.

The JAX parameters are carried across as they are
(``convert.params_from_flat(checkpoint._flatten(...))``), and the same
batch, drawn with numpy from a seed, goes through both packages on the CPU
in float32. Tolerances:

- forward: logits, every activation and the latent within 1e-5 absolute
  (values of order 1; the two frameworks' sigmoid, tanh and matmuls may
  round differently in the last bit, over at most 3 stacked layers of
  20 steps);
- gradients: each leaf within 1e-4 of that leaf's largest |g| (the batch
  and time sums run in other orders);
- the straight-through quantizer: forward equal to
  ``dequantize(quantize(x))`` bit for bit, backward the identity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import bottleneck as JBN
from repro.core import quant as JQ
from repro.data import lumos5g
from repro.models import lstm as JL
from repro.training import checkpoint
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import flat_from_params, params_from_flat
from repro_torch.core import bottleneck as TBN
from repro_torch.core import cascade as TC
from repro_torch.core import quant as TQ
from repro_torch.models import lstm as TL

FWD_ABS = 1e-5
GRAD_REL = 1e-4


def _setup(seed=0, batch=24):
    jcfg = j_reduced("lumos5g-lstm")
    tcfg = t_reduced("lumos5g-lstm")
    assert jcfg == type(jcfg)(**vars(tcfg))
    jp = JL.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_flat(checkpoint._flatten(jp), device="cpu")
    d = lumos5g.generate(lumos5g.Lumos5GConfig(
        n_samples=400, seq_len=jcfg.seq_len, seed=seed))
    b = next(lumos5g.batch_iterator(d, batch, seed))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    return jcfg, tcfg, jp, tp, jb, tb


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def test_lstm_layer_apply_matches():
    rng = np.random.default_rng(3)
    flat = {"wx/w": rng.normal(size=(11, 64)) / 3,
            "wx/b": rng.normal(size=(64,)) / 5,
            "wh/w": rng.normal(size=(16, 64)) / 4}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    x = rng.normal(size=(5, 20, 11)).astype(np.float32)
    jp = {"wx": {"w": jnp.asarray(flat["wx/w"]), "b": jnp.asarray(
        flat["wx/b"])}, "wh": {"w": jnp.asarray(flat["wh/w"])}}
    tp = params_from_flat(flat, device="cpu")
    want = JL.lstm_layer_apply(jp, jnp.asarray(x))
    got = TL.lstm_layer_apply(tp, torch.from_numpy(x))
    assert got.shape == (5, 20, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=FWD_ABS)


def test_port_init_has_the_reference_tree():
    jcfg, tcfg, jp, _, _, _ = _setup()
    tp = TL.init_params(torch.Generator().manual_seed(0), tcfg)
    want = {k: v.shape for k, v in checkpoint._flatten(jp).items()}
    got = {k: v.shape for k, v in flat_from_params(tp).items()}
    assert got == want
    assert all(t.dtype == torch.float32 for t in TC.opt.leaves(tp))


@pytest.mark.parametrize("mode", [0, 1])
def test_forward_loss_and_acc_match(mode):
    jcfg, tcfg, jp, tp, jb, tb = _setup()
    jl, ja = JL.forward(jp, jb["x"], jcfg, mode)
    tl, ta = TL.forward(tp, tb["x"], tcfg, mode)
    assert sorted(ta) == sorted(ja)
    assert ("H3" in ta) == (mode == 1)
    for k in ja:
        assert tuple(ta[k].shape) == ja[k].shape, k
        np.testing.assert_allclose(_np(ta[k]), _np(ja[k]), rtol=0,
                                   atol=FWD_ABS, err_msg=k)
    jloss, jm = JL.loss_fn(jp, jb, jcfg, mode)
    tloss, tm = TL.loss_fn(tp, tb, tcfg, mode)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                               atol=FWD_ABS)
    # the argmax may flip only where two logits are within the tolerance
    assert abs(float(tm["acc"]) - float(jm["acc"])) <= 1 / tb["y"].numel()


@pytest.mark.parametrize("mode", [0, 1])
def test_grads_match_every_leaf(mode):
    """Every leaf's gradient, frozen ones included: mode 1 differentiates
    the encoder and decoder too (the reference's global norm takes them);
    in mode 0 the bottleneck and adapter lie outside the graph, None in the
    port and zeros in JAX."""
    jcfg, tcfg, jp, tp, jb, tb = _setup(seed=1)
    (jloss, _), jg = jax.value_and_grad(JL.loss_fn, has_aux=True)(
        jp, jb, jcfg, mode)
    (tloss, _), tg = TC.value_and_grad(
        lambda p, b, m: TL.loss_fn(p, b, tcfg, m), tp, tb, mode)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=0,
                               atol=FWD_ABS)
    jflat = checkpoint._flatten(jg)
    tflat = flat_from_params(tg)
    outside = {k for k in jflat if k.split("/")[0] in ("bneck", "adapter")}
    if mode == 0:
        assert sorted(tflat) == sorted(set(jflat) - outside)
        for k in outside:
            assert not np.any(jflat[k]), k
    else:
        assert sorted(tflat) == sorted(jflat)
    for k, g in tflat.items():
        big = float(np.abs(jflat[k]).max())
        assert big > 0, k
        np.testing.assert_allclose(g, jflat[k], rtol=0,
                                   atol=GRAD_REL * big, err_msg=k)


@pytest.mark.parametrize("phase", [1, 2])
def test_phase_mask_matches(phase):
    _, tcfg, jp, tp, _, _ = _setup()
    want = {k: bool(v) for k, v in
            checkpoint._flatten(JL.phase_mask(jp, phase)).items()}
    got = {}
    for k, v in TL.phase_mask(tp, phase).items():
        for path, leaf in checkpoint._flatten(v).items():
            got[f"{k}/{path}"] = bool(leaf)
    assert got == want
    trainable = TL.PHASE1_KEYS if phase == 1 else TL.PHASE2_KEYS
    assert {k.split("/")[0] for k, t in got.items() if t} == set(trainable)


@pytest.mark.parametrize("bits", [8, 4, 1, 0])
def test_ste_quantize_forward_and_backward(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(6, 5, 24)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TQ.ste_quantize(xt, bits)
    if bits:
        q, s = TQ.quantize(torch.from_numpy(x), bits)
        plain = TQ.dequantize(q, s, bits)
    else:
        plain = torch.from_numpy(x)
    assert torch.equal(y.detach(), plain) and y.dtype == xt.dtype
    np.testing.assert_array_equal(_np(y), _np(JQ.ste_quantize(
        jnp.asarray(x), bits)))
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    jgx = jax.grad(lambda a: jnp.sum(JQ.ste_quantize(a, bits)
                                     * jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_array_equal(_np(gx), g)
    np.testing.assert_array_equal(_np(gx), _np(jgx))
    if bits:
        np.testing.assert_allclose(float(TQ.quant_error(
            torch.from_numpy(x), bits)), float(JQ.quant_error(
                jnp.asarray(x), bits)), rtol=1e-6)


def test_bottleneck_encode_train_matches():
    """``encode(train=True)``: the fake-quantized float code, no scales,
    and gradients reaching layer A; ``train=False`` keeps the int8 wire."""
    rng = np.random.default_rng(5)
    d, w = 48, 12
    flat = {"norm/scale": 1 + 0.1 * rng.normal(size=d),
            "down/w": rng.normal(size=(d, w)) / 7,
            "up/w": rng.normal(size=(w, d)) / 4}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    jh = {"norm": {"scale": jnp.asarray(flat["norm/scale"])},
          "down": {"w": jnp.asarray(flat["down/w"])},
          "up": {"w": jnp.asarray(flat["up/w"])}}
    th = params_from_flat(flat, device="cpu")
    x = rng.normal(size=(4, 3, d)).astype(np.float32)
    jz, js = JBN.encode(jh, jnp.asarray(x), 8, train=True)
    tz, ts = TBN.encode(th, torch.from_numpy(x), 8, train=True)
    assert js is None and ts is None and tz.dtype == torch.float32
    np.testing.assert_allclose(_np(tz), _np(jz), rtol=1e-6, atol=1e-6)
    codes, scales = TBN.encode(th, torch.from_numpy(x), 8)
    assert codes.dtype == torch.int8
    torch.testing.assert_close(TQ.dequantize(codes, scales, 8), tz,
                               rtol=0, atol=0)
    down = th["down"]["w"].clone().requires_grad_(True)
    z, _ = TBN.encode(dict(th, down={"w": down}), torch.from_numpy(x), 8,
                      train=True)
    (gd,) = torch.autograd.grad(z.sum(), down)
    jgd = jax.grad(lambda wd: jnp.sum(JBN.encode(
        dict(jh, down={"w": wd}), jnp.asarray(x), 8, train=True)[0]))(
            jh["down"]["w"])
    np.testing.assert_allclose(_np(gd), _np(jgd), rtol=1e-5, atol=1e-5)
