// Hopper (sm_90a) kernel for the Pallas TPU kernel bottleneck_quant
// (replaces src/repro/kernels/bottleneck_quant.py:48, pallas_call at :64,
// body _kernel at :26): the encoder-side transmit op, a down-projection
// with a fused row-wise symmetric quantization.
//
//   z = f32(x) @ f32(w)                       x [M, K], w [K, N], f32 sums
//   scale = max(max_n |z[m, n]|, 1e-8) / qmax  f32 division, per row
//   codes = clip(round_half_even(z / scale), -qmax, qmax) as int8
//
// with qmax = max(2^(bits-1) - 1, 1) (bits 1 is the ternary code). x and w
// are both bf16 or both f32; the outputs are the int8 codes and one f32
// scale per row (the wire payload).
//
// Rounding, as the reference: the division is __fdiv_rn (nvcc is given no
// --use_fast_math, and the explicit intrinsic keeps it a true f32 division,
// never a multiply by a reciprocal); rintf rounds half to even like
// jnp.round. The product is plain f32 FMAs with k ascending (no tensor
// cores: f32 inputs must not pass through TF32), so the kernel differs from
// the plain version only by summation order.
//
// Bound: at the bench's f32 shape (512 x 2048 x 512) operations, 1.07 GFLOP
// at the f32 FMA peak; at a bf16 wire of a few rows, bytes (the weights).
// Design: on the TPU one grid row of blocks walks K sequentially into a VMEM
// accumulator and quantizes in its last step. Here one block per row tile
// holding whole rows would leave M / 16 blocks, 32 at M 512, on a quarter
// of the SMs, so K is split into n_ks slices: pass 1 runs one block per
// (16-row tile, K slice), walking N in passes of 512 columns and its K
// slice in staged 32-deep tiles of x and w (wire_tile.cuh), and writes its
// f32 partial sums; pass 2 runs one block per row, sums the slices in
// slice order (a fixed order), and quantizes: absmax, scale, codes. The
// f32 partials (n_ks x M x N) are the only intermediate in device memory
// (the TPU keeps its accumulator in VMEM), 8 MB at the bench shape. wgmma
// tiles, vector loads and asynchronous (cp.async / TMA) staging are later
// work.
#include <cstdint>

#include "common.cuh"
#include "wire_tile.cuh"

using rt::bf16;

namespace {

using wire::kBK;
using wire::kCols;
using wire::kRows;
using wire::kThreads;

// pass 1: partial[ks][m][n] = sum over k in slice ks, ascending, of
// x[m][k] * w[k][n]
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bq_partial(const T* __restrict__ x, const T* __restrict__ w,
               float* __restrict__ partial, int M, int K, int N, int k_slice) {
  __shared__ float xs[kRows * kBK];   // a tile of x
  extern __shared__ float ws[];       // [kBK][kCols]: a tile of w
  const wire::Lane ln = wire::lane_of(threadIdx.x);
  const int m0 = blockIdx.x * kRows;
  const int kb = blockIdx.y * k_slice;
  const int ke = min(K, kb + k_slice);
  float* out = partial + (size_t)blockIdx.y * M * N;
  for (int n0 = 0; n0 < N; n0 += kCols) {
    float acc[wire::kTR][8] = {};
    for (int k0 = kb; k0 < ke; k0 += kBK) {
      __syncthreads();               // the previous tiles are consumed
      for (int i = threadIdx.x; i < kRows * kBK; i += kThreads) {
        const int r = i / kBK, k = i % kBK;
        xs[i] = (m0 + r < M && k0 + k < ke)
                    ? rt::to_f(x[(size_t)(m0 + r) * K + k0 + k])
                    : 0.f;
      }
      wire::stage_b(ws, w, N, k0, ke, n0, N);
      __syncthreads();
      wire::fma_tile(xs, kBK, ws, ln, acc);
    }
#pragma unroll
    for (int i = 0; i < wire::kTR; ++i) {
      const int m = m0 + ln.r0 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + ln.c + 32 * j;
        if (n < N) out[(size_t)m * N + n] = acc[i][j];
      }
    }
  }
}

// pass 2: block m sums row m's slices in order, then quantizes the row
__global__ void __launch_bounds__(kThreads)
    bq_quantize(const float* __restrict__ partial, int8_t* __restrict__ codes,
                float* __restrict__ scales, int M, int N, int n_ks,
                float qmax) {
  extern __shared__ float z[];        // [N]: the row's f32 sums
  __shared__ float wmax[kThreads / 32];
  const int m = blockIdx.x;
  float amax = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float v = partial[(size_t)m * N + n];
    for (int s = 1; s < n_ks; ++s)
      v = __fadd_rn(v, partial[((size_t)s * M + m) * N + n]);
    z[n] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = rt::warp_max(amax);
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = wmax[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) amax = fmaxf(amax, wmax[i]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), qmax);
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float q = rintf(__fdiv_rn(z[n], scale));
    codes[(size_t)m * N + n] = static_cast<int8_t>(fminf(fmaxf(q, -qmax),
                                                         qmax));
  }
  if (threadIdx.x == 0) scales[m] = scale;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, float* partial,
                   int8_t* codes, float* scales, int M, int K, int N,
                   int n_ks, float qmax, cudaStream_t stream) {
  const int k_slice = ((K + n_ks - 1) / n_ks + kBK - 1) / kBK * kBK;
  const size_t smem = sizeof(float) * kBK * kCols;
  cudaError_t e = rt::allow_smem(bq_partial<T>, smem);
  if (e != cudaSuccess) return e;
  bq_partial<T><<<dim3((M + kRows - 1) / kRows, n_ks), kThreads, smem,
                  stream>>>(static_cast<const T*>(x),
                            static_cast<const T*>(w), partial, M, K, N,
                            k_slice);
  bq_quantize<<<M, kThreads, sizeof(float) * N, stream>>>(
      partial, codes, scales, M, N, n_ks, qmax);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous tensors: x [M, K] and w [K, N] (both bf16 when is_bf16, else
// both f32), the scratch partial f32 [n_ks, M, N], codes int8 [M, N],
// scales f32 [M]. The caller keeps 1 <= N <= 4096 and n_ks >= 1. Returns
// cudaGetLastError().
extern "C" int bottleneck_quant_launch(const void* x, const void* w,
                                       float* partial, int8_t* codes,
                                       float* scales, int M, int K, int N,
                                       int n_ks, float qmax, int is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(x, w, partial, codes, scales, M, K, N, n_ks, qmax, s);
  return launch<float>(x, w, partial, codes, scales, M, K, N, n_ks, qmax, s);
}
