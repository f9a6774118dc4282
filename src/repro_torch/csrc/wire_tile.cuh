// The pieces shared by the two wire kernels (bottleneck_quant.cu,
// dequant_matmul.cu): the block shape, the swizzled shared-memory layout, a
// tile loader with a 16-byte and a narrow form, and the bf16 tensor-core
// warp tile. The tile sizes and the copy forms of a launch come from the plan
// in kernels/wire_plan.py, which mirrors the index math here.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace wire {

using rt::bf16;

constexpr int kThreads = 128;  // four warps a block

// Tiles sit in shared memory in dense rows (no padding), so a 128-byte
// line from device memory lands in one 128-byte segment. Against bank
// conflicts, a bf16 tile that ldmatrix reads (CC 16-byte chunks a row)
// permutes the chunks of each segment: chunk c of row r is stored at
// swz<CC>(r, c), so eight consecutive rows' chunk c hit eight distinct
// banks. Rows of 128 bytes or more swap chunks within their segments by r;
// rows of 64 bytes (CC = 4) pair up in a segment and swap by r / 2.
template <int CC>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CC == 4 || CC % 8 == 0, "rows of 64 bytes or whole segments");
  if constexpr (CC == 4)
    return (c ^ (r >> 1)) & 3;
  else
    return (c & ~7) | ((c ^ r) & 7);
}

template <int B> struct Raw;
template <> struct Raw<1> { using T = uint8_t; };
template <> struct Raw<2> { using T = uint16_t; };
template <> struct Raw<4> { using T = uint32_t; };

// Stage the tile g[r0 : r0 + R, c0 : c0 + C] of a row-major array (ld
// elements a row) into shared memory s, dense rows of C elements, chunks
// swizzled when kSwz; rows >= rmax and columns >= cmax read as zero, which
// adds exact zeros to every sum. vec: 16-byte cp.async copies, for a
// 16-byte aligned base with ld, c0 and cmax multiples of 16 bytes (a copy
// then lies wholly inside or outside the array); a tile wholly inside takes
// a loop without bounds tests. Else element loads, which land before the
// block's next barrier.
template <int R, int C, bool kSwz, typename T>
__device__ __forceinline__ void load_tile(T* s, const T* __restrict__ g,
                                          size_t ld, int r0, int rmax, int c0,
                                          int cmax, bool vec) {
  constexpr int E = 16 / sizeof(T);  // elements of a chunk
  constexpr int CC = C / E;          // chunks of a row
  static_assert(C % E == 0, "whole chunks");
  if (vec && r0 + R <= rmax && c0 + C <= cmax) {
    const T* gb = g + (size_t)r0 * ld + c0;
    for (int i = threadIdx.x; i < R * CC; i += kThreads) {
      const int r = i / CC, c = i % CC;
      rt::cp_async16(s + (r * CC + (kSwz ? swz<CC>(r, c) : c)) * E,
                     gb + (size_t)r * ld + c * E);
    }
  } else if (vec) {
    for (int i = threadIdx.x; i < R * CC; i += kThreads) {
      const int r = i / CC, c = i % CC;
      const bool ok = r0 + r < rmax && c0 + c * E < cmax;
      rt::cp_async16_or_zero(
          s + (r * CC + (kSwz ? swz<CC>(r, c) : c)) * E,
          ok ? g + (size_t)(r0 + r) * ld + c0 + c * E : g, ok);
    }
  } else {  // eight loads in flight a thread before their stores
    using U = typename Raw<sizeof(T)>::T;
    const U* gu = reinterpret_cast<const U*>(g);
    U* su = reinterpret_cast<U*>(s);
    constexpr int kBatch = 8;
    for (int i0 = threadIdx.x; i0 < R * C; i0 += kThreads * kBatch) {
      U v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads, r = i / C, c = i % C;
        v[j] = i < R * C && r0 + r < rmax && c0 + c < cmax
                   ? gu[(size_t)(r0 + r) * ld + c0 + c]
                   : U(0);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads, r = i / C, c = i % C;
        if (i < R * C)
          su[(r * CC + (kSwz ? swz<CC>(r, c / E) : c / E)) * E + c % E] = v[j];
      }
    }
  }
}

// The warp's tensor-core tile: acc[i][j] (rows 16 i + 0..15, columns 8 j +
// 0..7) += a[16 MT x KD] @ (sum over parts p < P of b_p[KD x 8 NT]), k
// ascending in 16-deep mma.sync steps; at each step the P parts of B go
// into one accumulator in part order. a is row-major [m][k], AC elements a
// row; b_p is [k][n], BC elements a row, at b + p * pstride, the warp's
// columns starting at column n0; all bf16 in swizzled shared memory. Thread
// t holds rows t / 4 (+8) and columns 2 (t % 4) + {0, 1} of each 16 x 8
// tile: acc[i][j][0..1] the first row, [2..3] the second.
template <int MT, int NT, int KD, int P, int AC, int BC>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][NT][4],
                                         const bf16* a, const bf16* b, int n0,
                                         int pstride) {
  static_assert(NT % 2 == 0 && KD % 16 == 0, "whole x4 fragments");
  const int lane = threadIdx.x & 31, q = lane >> 3, rr = lane & 7;
  // this lane's row of its matrix: q & 1 adds 8 rows (A) or 8 k (B), q >> 1
  // adds 8 k (A) or 8 columns (B)
  const int ar = (q & 1) * 8 + rr, bk = (q & 1) * 8 + rr;
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = 16 * i + ar;
      rt::ldmatrix_x4<false>(
          af[i], a + r * AC + swz<AC / 8>(r, (kk >> 3) + (q >> 1)) * 8);
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const int k = kk + bk;
        uint32_t bf[4];  // columns 8j: bf[0], bf[1]; 8j + 8: bf[2], bf[3]
        rt::ldmatrix_x4<true>(
            bf, b + p * pstride + k * BC +
                    swz<BC / 8>(k, ((n0 + 8 * j) >> 3) + (q >> 1)) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          rt::mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          rt::mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
  }
}

}  // namespace wire
