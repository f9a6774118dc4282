"""The port's two wire kernels on the CPU: the plain versions
``ref.bottleneck_quant_ref`` / ``ref.dequant_matmul_ref`` against the JAX
oracles (``repro.kernels.ref``) and the interpreted Pallas kernels, on
numpy-seeded inputs; the dispatchers of ``kernels.ops``; and the CUDA
wrappers, which import without ``nvcc`` and refuse CPU tensors.

Tolerances, and why:
- codes: the f32 sums of x @ w are taken in other orders by PyTorch, XLA
  and the interpreted kernel, so a code may move by one step where z /
  scale sits on a rounding edge: |delta| <= 1 on under 1% of lanes (the
  JAX package's own bound, ``tests/test_kernels.py``);
- scales: one row absmax divided by qmax in f32 on both sides, so only the
  absmax's summation order shows: rtol 1e-5;
- dequant_matmul: each bf16 output within one bf16 ulp of the JAX one (the
  f32 sums differ by order and may straddle one bf16 rounding edge), or,
  where the output is so small that the f32 sums' own rounding exceeds an
  ulp, within that rounding, 2 N 2^-24 sum_k |z_k| |w_k|.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bottleneck_quant import bottleneck_quant as j_bq_kernel
from repro.kernels.dequant_matmul import dequant_matmul as j_dq_kernel
from repro_torch.core import quant as TQ
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bottleneck_quant import bottleneck_quant
from repro_torch.kernels.dequant_matmul import dequant_matmul

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _inputs(M, K, N, dtype, seed=0):
    """x, w as numpy arrays of ``dtype`` (bf16 as ml_dtypes), and the same
    values as torch tensors."""
    npdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((M, K))).astype(np.float32).astype(npdt)
    w = (0.02 * rng.standard_normal((K, N))).astype(np.float32).astype(npdt)
    return x, w, _t(x, tdt), _t(w, tdt)


def _t(a, tdt):
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _check_codes(codes, want, qmax):
    diff = np.abs(np.asarray(codes, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01
    assert np.abs(np.asarray(codes, np.int32)).max() <= qmax


@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(16, 256, 128), (24, 384, 256)])
def test_bottleneck_quant_ref_matches_jax(M, K, N, dtype, bits):
    x, w, xt, wt = _inputs(M, K, N, dtype)
    codes, scales = ref.bottleneck_quant_ref(xt, wt, bits)
    assert codes.dtype == torch.int8 and codes.shape == (M, N)
    assert scales.dtype == torch.float32 and scales.shape == (M, 1)
    qm = max((1 << (bits - 1)) - 1, 1)
    j_ref = jref.bottleneck_quant_ref(jnp.asarray(x), jnp.asarray(w), bits)
    j_ker = j_bq_kernel(jnp.asarray(x), jnp.asarray(w), bits=bits,
                        block_m=8, block_k=128, interpret=True)
    for jc, js in (j_ref, j_ker):
        _check_codes(codes.numpy(), np.asarray(jc), qm)
        np.testing.assert_allclose(scales.numpy(), np.asarray(js),
                                   rtol=1e-5)


def _bf16_close(y, want, env):
    """Each element within one bf16 ulp of ``want`` or within ``env``."""
    y = np.asarray(y, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(y), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    err = np.abs(y - want)
    ok = (err <= ulp) | (err <= env)
    assert ok.all(), (err[~ok].max(), int((~ok).sum()))


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,D", [(16, 128, 256), (8, 256, 512)])
def test_dequant_matmul_ref_matches_jax(M, N, D, w_dtype):
    rng = np.random.default_rng(1)
    npdt, tdt = DTYPES[w_dtype]
    z = rng.standard_normal((M, N)).astype(np.float32)
    codes, scales = jref.bottleneck_quant_ref(jnp.asarray(z),
                                              jnp.eye(N, dtype=jnp.float32))
    codes, scales = np.array(codes), np.array(scales)
    w = (0.05 * rng.standard_normal((N, D))).astype(np.float32).astype(npdt)
    y = ref.dequant_matmul_ref(torch.from_numpy(codes),
                               torch.from_numpy(scales), _t(w, tdt))
    assert y.dtype == torch.bfloat16 and y.shape == (M, D)
    zf = codes.astype(np.float32) * scales
    env = 2 * N * 2.0 ** -24 * (np.abs(zf) @ np.abs(np.asarray(w, np.float32)))
    for want in (jref.dequant_matmul_ref(codes, scales, jnp.asarray(w)),
                 j_dq_kernel(codes, scales, jnp.asarray(w), block_m=8,
                             block_d=256, interpret=True)):
        _bf16_close(y.float().numpy(), want, env)
    y32 = ref.dequant_matmul_ref(torch.from_numpy(codes),
                                 torch.from_numpy(scales), _t(w, tdt),
                                 out_dtype=torch.float32)
    want32 = jref.dequant_matmul_ref(codes, scales, jnp.asarray(w),
                                     out_dtype=jnp.float32)
    np.testing.assert_allclose(y32.numpy(), np.asarray(want32), rtol=0,
                               atol=float(env.max()))


def test_dispatchers_flatten_leading_dims():
    """``ops.*_op`` take [..., K] / [..., N] activations, run the plain
    versions on CPU tensors and give back the leading dims."""
    _, _, xt, wt = _inputs(2 * 3 * 5, 64, 32, "bfloat16", seed=2)
    x3 = xt.reshape(2, 3, 5, 64)
    codes, scales = ops.bottleneck_quant_op(x3, wt, bits=4)
    assert codes.shape == (2, 3, 5, 32) and scales.shape == (2, 3, 5, 1)
    c2, s2 = ref.bottleneck_quant_ref(xt, wt, 4)
    assert torch.equal(codes.reshape(-1, 32), c2)
    assert torch.equal(scales.reshape(-1, 1), s2)
    w_up = torch.randn((32, 48), generator=torch.Generator().manual_seed(0))
    y = ops.dequant_matmul_op(codes, scales, w_up)
    assert y.shape == (2, 3, 5, 48) and y.dtype == torch.bfloat16
    assert torch.equal(y.reshape(-1, 48),
                       ref.dequant_matmul_ref(c2, s2, w_up))


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_wire_format_of_quant_module_and_zero_rows(bits):
    """The plain version produces ``core.quant``'s wire format at every bit
    width (bits 1 is the ternary code: finite scales, codes in {-1, 0,
    1}), and a row of exact zeros gives the scale 1e-8 / qmax and zero
    codes."""
    _, _, xt, wt = _inputs(16, 128, 64, "float32", seed=3)
    xt[5] = 0.0
    codes, scales = ref.bottleneck_quant_ref(xt, wt, bits)
    q_codes, q_scales = TQ.quantize(xt @ wt, bits)
    qm = TQ.qmax(bits)
    assert torch.isfinite(scales).all()
    np.testing.assert_allclose(scales.numpy(), q_scales.numpy(), rtol=1e-5)
    _check_codes(codes.numpy(), q_codes.numpy(), qm)
    assert float(scales[5, 0]) == np.float32(1e-8) / np.float32(qm)
    assert not codes[5].any()


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers import without nvcc (nothing builds at import)
    and raise on a CPU tensor rather than fall back; nothing launches."""
    x = torch.zeros((8, 64))
    w = torch.zeros((64, 32))
    codes = torch.zeros((8, 32), dtype=torch.int8)
    scales = torch.ones((8, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        bottleneck_quant(x, w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dequant_matmul(codes, scales, w[:32])
    assert bottleneck_quant.launches == 0 and dequant_matmul.launches == 0
