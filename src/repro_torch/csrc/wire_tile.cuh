// The f32 tile product shared by the two wire kernels (bottleneck_quant.cu,
// dequant_matmul.cu): a block of kThreads threads computes kRows rows by
// kCols columns of A[rows, k] @ B[k, cols] with plain f32 FMAs, k ascending
// (a fixed summation order, no tensor cores, so f32 inputs never pass
// through TF32).
//
// Thread layout: warp w owns the four rows 4 * (w % 4) + i, i < 4, and the
// column group g = w / 4 of 256 columns; lane l owns columns
// g * 256 + l + 32 * j, j < 8. A row operand is then one broadcast shared
// load per warp, each of the eight B loads is conflict-free, and every 12
// shared loads feed 32 FMAs.
#pragma once

#include "common.cuh"

namespace wire {

constexpr int kThreads = 256;
constexpr int kRows = 16;     // rows of a block
constexpr int kCols = 512;    // columns of one pass (two groups of 256)
constexpr int kBK = 32;       // depth of one staged B tile

constexpr int kTR = 4;        // rows of a thread
struct Lane {
  int r0;   // first of the thread's four rows
  int c;    // first of its eight columns (then c + 32 j)
};

__device__ __forceinline__ Lane lane_of(int tid) {
  const int w = tid >> 5;
  return {kTR * (w & 3), (w >> 2) * 256 + (tid & 31)};
}

// Stage B[k0 : k0 + kBK, n0 : n0 + kCols] (row stride ldb) into ws as f32,
// zero outside [0, K) x [0, N): zero rows add exact zeros to every sum.
template <typename TB>
__device__ __forceinline__ void stage_b(float* ws, const TB* __restrict__ b,
                                        int ldb, int k0, int K, int n0,
                                        int N) {
#pragma unroll 8
  for (int i = threadIdx.x; i < kBK * kCols; i += kThreads) {
    const int k = i / kCols, n = i % kCols;
    ws[i] = (k0 + k < K && n0 + n < N)
                ? rt::to_f(b[(size_t)(k0 + k) * ldb + n0 + n])
                : 0.f;
  }
}

// acc[i][j] += sum over k < kBK, ascending, of a[(r0 + i) * lda + k] *
// ws[k * kCols + c + 32 j]
__device__ __forceinline__ void fma_tile(const float* a, int lda,
                                         const float* ws, Lane ln,
                                         float (&acc)[kTR][8]) {
#pragma unroll 4
  for (int k = 0; k < kBK; ++k) {
    float av[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) av[i] = a[(ln.r0 + i) * lda + k];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float bv = ws[k * kCols + ln.c + 32 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
    }
  }
}

}  // namespace wire
