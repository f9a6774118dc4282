"""The port's layers, quantizer and bottleneck against the JAX package.

The same inputs, drawn with numpy from a seed, go through both packages on
the CPU. In float32 the two must agree to 1e-6 (relative and absolute: sums
of at most a few hundred terms taken in two orders). In bfloat16 both round
the same f32 values to the same bf16 grid, so they may differ where one
f32 sum straddles a rounding edge: within 2 bf16 ulps (2^-7) of each value
and of the largest value of the result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bottleneck as JB
from repro.core import quant as JQ
from repro.configs import get_reduced as j_reduced
from repro.models import layers as JL
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_flat
from repro_torch.core import bottleneck as TB
from repro_torch.core import quant as TQ
from repro_torch.models import layers as TL

torch.backends.cuda.matmul.allow_tf32 = False   # as tests/conftest.py pins
torch.backends.cudnn.allow_tf32 = False         # JAX to full f32 matmuls

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, name):
    jd, td = DTYPES[name]
    t = torch.from_numpy(np.asarray(a, np.float32)).to(td)
    return jnp.asarray(a, jd), t


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _close(j, t, name):
    if name == "float32":
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6, atol=1e-6)
    else:
        # 2 bf16 ulps of each value and of the largest value: a composed op
        # (the MLP's three products) compounds the intermediate roundings
        big = float(np.abs(_np(j)).max())
        np.testing.assert_allclose(_np(t), _np(j), rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * max(big, 1.0))


def _to_torch(a):
    """A JAX array as a torch tensor, bit for bit."""
    return params_from_flat({"a": np.asarray(a)}, device="cpu")["a"]


def _tree(flat_np, name):
    """One parameter tree in both packages (torch via ``params_from_flat``)."""
    jd = DTYPES[name][0]
    flat_j = {k: jnp.asarray(v, jd) for k, v in flat_np.items()}
    jt = {}
    for k, v in flat_j.items():
        *head, leaf = k.split("/")
        node = jt
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = v
    tt = params_from_flat({k: np.asarray(v) for k, v in flat_j.items()},
                          device="cpu")
    return jt, tt


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_dense_embed_and_mlp_match(name):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64))
    flat = {"w": rng.normal(size=(64, 48)) / 8, "b": rng.normal(size=(48,))}
    jp, tp = _tree(flat, name)
    xj, xt = _both(x, name)
    _close(JL.dense_apply(jp, xj), TL.dense_apply(tp, xt), name)

    table = rng.normal(size=(50, 64))
    jt, tt = _tree({"table": table}, name)
    ids = rng.integers(0, 50, size=(3, 7))
    _close(JL.embed_apply(jt, jnp.asarray(ids)),
           TL.embed_apply(tt, torch.from_numpy(ids)), name)

    mlp = {f"{k}/w": rng.normal(size=s) / 8 for k, s in
           (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}
    jm, tm = _tree(mlp, name)
    for act in ("silu", "gelu"):
        _close(JL.mlp_apply(jm, xj, act), TL.mlp_apply(tm, xt, act), name)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches(name, kind):
    rng = np.random.default_rng(1)
    x = 3 * rng.normal(size=(4, 3, 128))
    flat = {"scale": 1 + 0.1 * rng.normal(size=128)}
    if kind == "layernorm":
        flat["bias"] = 0.1 * rng.normal(size=128)
    jp, tp = _tree(flat, name)
    xj, xt = _both(x, name)
    out = TL.norm_apply(tp, xt, kind)
    assert out.dtype == DTYPES[name][1]
    _close(JL.norm_apply(jp, xj, kind), out, name)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_rope_matches(name):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 4, 32))
    pos = rng.integers(0, 4000, size=(2, 6)).astype(np.int32)
    xj, xt = _both(x, name)
    _close(JL.apply_rope(xj, jnp.asarray(pos), 1e6),
           TL.apply_rope(xt, torch.from_numpy(pos), 1e6), name)


@pytest.mark.parametrize("bits", [8, 4, 2, 1])
def test_quantize_matches(bits):
    """Codes are equal (both round half to even); scales to f32 rounding."""
    assert TQ.qmax(bits) == JQ.qmax(bits)
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]                 # exact half steps
    x[0, 4:] = 0.0
    x[0, 5] = 2.5 * 2 * JQ.qmax(bits) / 5           # absmax on the grid
    jq, js = JQ.quantize(jnp.asarray(x), bits)
    tq, ts = TQ.quantize(torch.from_numpy(x), bits)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(TQ.dequantize(tq, ts, bits).numpy(),
                               np.asarray(JQ.dequantize(jq, js, bits)),
                               rtol=1e-7)


@pytest.mark.parametrize("shape,bits", [((1, 1, 2048), 0), ((1, 1, 512), 8),
                                        ((3, 16, 512), 4), ((1, 5, 384), 1),
                                        ((2, 7, 33), 2)])
def test_payload_bytes_match(shape, bits):
    assert TQ.payload_bytes(shape, bits) == JQ.payload_bytes(shape, bits)


def _bank_flat(rng, d, widths_bits):
    flat = {}
    for i, (w, _) in enumerate(widths_bits):
        flat[f"{i}/norm/scale"] = 1 + 0.1 * rng.normal(size=d)
        flat[f"{i}/down/w"] = rng.normal(size=(d, w)) / np.sqrt(d)
        flat[f"{i}/up/w"] = rng.normal(size=(w, d)) / np.sqrt(w)
    return flat


def _j_bank(flat, n, name):
    jd = DTYPES[name][0]
    return tuple({"norm": {"scale": jnp.asarray(flat[f"{i}/norm/scale"], jd)},
                  "down": {"w": jnp.asarray(flat[f"{i}/down/w"], jd)},
                  "up": {"w": jnp.asarray(flat[f"{i}/up/w"], jd)}}
                 for i in range(n))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_bottleneck_bank_encode_decode_and_boundary(name):
    """``bank_stack``, per-head ``encode``/``decode`` and the CPU boundary
    (the serving reference) on a bank with widths 32/16 and bits 8/4/1/0."""
    import dataclasses

    from repro.configs.base import SplitConfig as JSplit
    from repro_torch.configs import SplitConfig as TSplit
    extra = ((16, 4), (24, 1), (8, 0))
    jcfg = dataclasses.replace(j_reduced("qwen2.5-3b"), split=JSplit(
        split_at=1, d_bottleneck=32, quant_bits=8, extra_modes=extra))
    tcfg = dataclasses.replace(t_reduced("qwen2.5-3b"), split=TSplit(
        split_at=1, d_bottleneck=32, quant_bits=8, extra_modes=extra))
    assert TB.mode_widths(tcfg.split) == JB.mode_widths(jcfg.split)
    M = len(TB.mode_widths(tcfg.split))
    for mode in range(M + 1):
        for B, S in ((1, 1), (3, 5)):
            assert TB.mode_payload_bytes(tcfg, B, S, mode) == \
                JB.mode_payload_bytes(jcfg, B, S, mode)

    rng = np.random.default_rng(3)
    d = tcfg.d_model
    flat = _bank_flat(rng, d, TB.mode_widths(tcfg.split))
    jbank = _j_bank(flat, M, name)
    tbank = _tree(flat, name)[1]
    js = JB.bank_stack(jbank, jcfg.split)
    ts = TB.bank_stack(tbank, tcfg.split)
    for k in js:
        np.testing.assert_array_equal(_np(ts[k]), _np(js[k]))

    x = 2 * rng.normal(size=(6, 3, d))
    xj, xt = _both(x, name)
    for m, (w, bits) in enumerate(TB.mode_widths(tcfg.split)):
        jc, jsc = JB.encode(jbank[m], xj, bits)
        tc, tsc = TB.encode(tbank[m], xt, bits)
        if name == "float32" and bits:
            # codes may differ only where z / scale sits on a half step
            assert (np.abs(tc.numpy() - np.asarray(jc)) <= 1).all()
            assert (tc.numpy() != np.asarray(jc)).mean() < 0.01
        jd = JB.decode(jbank[m], jc, jsc, bits, dtype=DTYPES[name][0])
        td = TB.decode(tbank[m], _to_torch(jc),
                       None if jsc is None else _to_torch(jsc), bits,
                       dtype=DTYPES[name][1])
        _close(jd, td, name)

    modes = np.array([0, 1, 2, 3, 4, 1], np.int32)
    yj = JB.boundary_mixed(js, xj, jnp.asarray(modes), dtype=DTYPES[name][0])
    yt = TB.boundary_mixed(ts, xt, torch.from_numpy(modes),
                           dtype=DTYPES[name][1])
    np.testing.assert_array_equal(_np(yt)[modes == 0], _np(yj)[modes == 0])
    # quantized rows: a code may flip where z / scale sits on a rounding
    # edge, which these inputs do not reach; f32 sums in two orders stay
    # within 1e-5, bf16 within the envelope of the other bf16 checks
    if name == "float32":
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=1e-5, atol=1e-5)
    else:
        _close(yj, yt, name)
    assert np.isfinite(_np(yt)).all()
