// Hopper (sm_90a) kernel for the Pallas TPU kernel dequant_matmul (replaces
// src/repro/kernels/dequant_matmul.py:25, pallas_call at :35, body _kernel
// at :18): the decoder-side receive op, a fused dequantize and
// up-projection.
//
//   y = ((f32(codes) * scales) @ f32(w)) as out_dtype
//       codes int8 [M, N], scales f32 [M, 1], w [N, D] bf16 or f32,
//       y [M, D] bf16 (the reference's default) or f32
//
// Rounding, as the reference: each operand z = f32(code) * scale is one f32
// product (__fmul_rn, so it can never fuse into the next FMA), the product
// with w is plain f32 FMAs with k ascending, and the output is rounded once
// (__float2bfloat16_rn, half to even like XLA's convert). Dequantizing the
// operand first is the reference's f32 product; scale * (codes @ w) would
// round differently.
//
// Bound: at the bench's shape (512 x 512 x 2048, f32 w) operations, 1.07
// GFLOP at the f32 FMA peak (the dequantized operand is f32); at a bf16
// wire of a few rows, bytes (the up-projection weights). Design: one block
// per (16-row tile, 512-column tile); the block dequantizes its 16 code rows
// into shared memory once (16 x N f32, zero-padded to a multiple of the
// 32-deep tile; N <= 2048 keeps it and a tile of w within 227 KB), then
// walks N in staged 32-deep tiles of w (wire_tile.cuh). As on the TPU, no
// f32 copy of the code matrix is ever written to device memory.
#include <cstdint>

#include "common.cuh"
#include "wire_tile.cuh"

using rt::bf16;

namespace {

using wire::kBK;
using wire::kCols;
using wire::kRows;
using wire::kThreads;

template <typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
    dequant_matmul_kernel(const int8_t* __restrict__ codes,
                          const float* __restrict__ scales,
                          const TW* __restrict__ w, TO* __restrict__ y, int M,
                          int N, int D) {
  extern __shared__ float smem[];
  const int Np = (N + kBK - 1) / kBK * kBK;
  float* zs = smem;                // [kRows][Np]: the dequantized codes
  float* ws = zs + kRows * Np;     // [kBK][kCols]: a tile of w
  const int m0 = blockIdx.x * kRows;
  const int d0 = blockIdx.y * kCols;
  for (int i = threadIdx.x; i < kRows * Np; i += kThreads) {
    const int r = i / Np, n = i % Np;
    zs[i] = (m0 + r < M && n < N)
                ? __fmul_rn(static_cast<float>(codes[(size_t)(m0 + r) * N + n]),
                            scales[m0 + r])
                : 0.f;
  }
  const wire::Lane ln = wire::lane_of(threadIdx.x);
  float acc[wire::kTR][8] = {};
  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();               // zs is filled / the previous tile used
    wire::stage_b(ws, w, D, k0, N, d0, D);
    __syncthreads();
    wire::fma_tile(zs + k0, Np, ws, ln, acc);
  }
#pragma unroll
  for (int i = 0; i < wire::kTR; ++i) {
    const int m = m0 + ln.r0 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = d0 + ln.c + 32 * j;
      if (col < D) y[(size_t)m * D + col] = rt::from_f<TO>(acc[i][j]);
    }
  }
}

template <typename TW, typename TO>
cudaError_t launch(const int8_t* codes, const float* scales, const void* w,
                   void* y, int M, int N, int D, cudaStream_t stream) {
  const int Np = (N + kBK - 1) / kBK * kBK;
  const size_t smem = sizeof(float) * (kRows * Np + kBK * kCols);
  cudaError_t e = rt::allow_smem(dequant_matmul_kernel<TW, TO>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kRows - 1) / kRows, (D + kCols - 1) / kCols);
  dequant_matmul_kernel<TW, TO><<<grid, kThreads, smem, stream>>>(
      codes, scales, static_cast<const TW*>(w), static_cast<TO*>(y), M, N, D);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous tensors: codes int8 [M, N], scales f32 [M], w [N, D] (bf16 when
// w_bf16, else f32), y [M, D] (bf16 when out_bf16, else f32). The caller
// keeps 1 <= N <= 2048. Returns cudaGetLastError().
extern "C" int dequant_matmul_launch(const int8_t* codes, const float* scales,
                                     const void* w, void* y, int M, int N,
                                     int D, int w_bf16, int out_bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return out_bf16 ? launch<bf16, bf16>(codes, scales, w, y, M, N, D, s)
                    : launch<bf16, float>(codes, scales, w, y, M, N, D, s);
  return out_bf16 ? launch<float, bf16>(codes, scales, w, y, M, N, D, s)
                  : launch<float, float>(codes, scales, w, y, M, N, D, s);
}
