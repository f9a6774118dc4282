// Hopper (sm_90a) kernel for the Pallas TPU kernel dequant_matmul (replaces
// src/repro/kernels/dequant_matmul.py:25, pallas_call at :35, body _kernel
// at :18): the decoder-side receive op, a fused dequantize and
// up-projection.
//
//   y = ((f32(codes) * scales) @ f32(w)) as out_dtype
//       codes int8 [M, N], scales f32 [M, 1], w [N, D] bf16 or f32,
//       y [M, D] bf16 (the reference's default) or f32
//
// Bound: at the timed shapes (512 rows, N 512-640, D 2048-2560) the bytes
// (the weights and y, 4.5-6.2 MB) and one bf16 tensor-core pass over the
// product take about the same least time, 1.1-1.9 us; at a few rows, the
// weights' bytes. What holds the kernel back is neither: each block's
// cp.async stream from L2 (~15-25 bytes a clock) and the barriers of its
// eight 64-deep steps.
//
// Rounding: the codes are integers with |c| <= 127, exact in bf16, so the
// product runs on the tensor cores (mma.sync m16n8k16, f32 accumulation):
// y = round_out(scale_m * sum_k c_k w_k). A bf16 w is one operand; an f32 w
// is the exact sum of three bf16 parts (hi = bf16(w), mid = bf16(w - hi),
// lo = bf16(w - hi - mid), each remainder exact in f32; only where lo would
// be subnormal does the split drop bits), split as it is staged, and the
// three products go into one accumulator. Every product c * part is exact
// in f32, so only the accumulation rounds. The reference rounds c * scale
// before each term instead; multiplying by the scale once after the sum
// (__fmul_rn) differs from it by that rounding, within the tolerance that
// already covers the two sides' summation orders (one bf16 ulp + 2 N
// 2^-24 sum_k |z_k w_k|). The output is rounded once (__float2bfloat16_rn,
// half to even like XLA's convert).
//
// Design: one block of four warps per (BM x BN) output tile, BM in 16, 32,
// 64 and BN in 64, 128, picked by kernels/wire_plan.py (the tile whose
// blocks stream the fewest bytes an SM among those that give every SM a
// block). The depth N streams in 64-deep tiles through a 3-stage cp.async
// ring (16-byte copies into dense rows; element loads where a row of codes
// or of w breaks 16-byte alignment, zeros past the edges). Each tile's
// codes are widened to bf16 once for the block (and an f32 w tile split
// into its three parts) into rows swizzled against bank conflicts; the
// warps take ldmatrix fragments from them and a bf16 w tile straight from
// the ring. Each warp owns BM rows by BN / 4 columns, so no value is
// widened or split twice. As on the TPU, no dequantized copy of the codes
// is ever written to device memory: one device kernel a call.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "wire_tile.cuh"

using rt::bf16;

namespace {

using wire::kThreads;
using wire::swz;

constexpr int kStages = 3;  // depth of the cp.async ring
constexpr int kBK = 64;     // depth of a staged tile

template <int BM, int BN, typename TW>
struct Layout {
  static constexpr int kParts = std::is_same<TW, float>::value ? 3 : 1;
  static constexpr int kStageA = BM * kBK;      // int8 codes
  static constexpr int kStageB = kBK * BN * (int)sizeof(TW);  // raw w
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kWide = BM * kBK * 2;    // widened codes
  static constexpr int kSplit = kParts == 1 ? 0 : kParts * kBK * BN * 2;
  static constexpr int kBytes = kStages * kStage + kWide + kSplit;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_value(uint32_t packed, int half) {
  return __uint_as_float(half ? packed & 0xffff0000u : packed << 16);
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int MT, int NT, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
    dequant_matmul_kernel(const int8_t* __restrict__ codes,
                          const float* __restrict__ scales,
                          const TW* __restrict__ w, TO* __restrict__ y, int M,
                          int N, int D, int vec_a, int vec_b) {
  constexpr int BM = 16 * MT, BN = 32 * NT;
  using L = Layout<BM, BN, TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wide = reinterpret_cast<bf16*>(smem + kStages * L::kStage);
  bf16* split = reinterpret_cast<bf16*>(smem + kStages * L::kStage + L::kWide);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (N + kBK - 1) / kBK;

  auto fetch = [&](int t) {
    if (t < nk) {
      unsigned char* st = smem + t % kStages * L::kStage;
      const int k0 = t * kBK;
      wire::load_tile<BM, kBK, false>(reinterpret_cast<int8_t*>(st), codes,
                                      N, m0, M, k0, N, vec_a);
      wire::load_tile<kBK, BN, L::kParts == 1>(
          reinterpret_cast<TW*>(st + L::kStageA), w, D, k0, N, n0, D, vec_b);
    }
    rt::cp_async_commit();  // empty past the last tile: a fixed wait count
  };

  float acc[MT][NT][4] = {};
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  for (int t = 0; t < nk; ++t) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; tile t - 1 is consumed
    fetch(t + kStages - 1);
    const unsigned char* st = smem + t % kStages * L::kStage;
    // widen the codes: 16 a thread and pass
    for (int i = threadIdx.x; i < BM * kBK / 16; i += kThreads) {
      const int r = i / (kBK / 16), c = i % (kBK / 16) * 16;
      const uint4 u = *reinterpret_cast<const uint4*>(st + r * kBK + c);
      const uint32_t src[4] = {u.x, u.y, u.z, u.w};
      uint32_t out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = src[j >> 1] >> (16 * (j & 1));
        out[j] = pack_bf16((float)(int8_t)(word & 0xff),
                           (float)(int8_t)((word >> 8) & 0xff));
      }
      bf16* row = wide + r * kBK;
      *reinterpret_cast<uint4*>(row + swz<kBK / 8>(r, c / 8) * 8) =
          make_uint4(out[0], out[1], out[2], out[3]);
      *reinterpret_cast<uint4*>(row + swz<kBK / 8>(r, c / 8 + 1) * 8) =
          make_uint4(out[4], out[5], out[6], out[7]);
    }
    const bf16* b = reinterpret_cast<const bf16*>(st + L::kStageA);
    if constexpr (L::kParts == 3) {
      // split f32 w into hi + mid + lo, four values a thread and pass
      const float* raw = reinterpret_cast<const float*>(st + L::kStageA);
      constexpr int kPS = kBK * BN;  // elements of one part
      for (int i = threadIdx.x; i < kBK * BN / 4; i += kThreads) {
        const int r = i / (BN / 4), c = i % (BN / 4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(raw + r * BN + c);
        float rem[4] = {v.x, v.y, v.z, v.w};
        bf16* dst = split + r * BN + swz<BN / 8>(r, c / 8) * 8 + c % 8;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const uint32_t h0 = pack_bf16(rem[0], rem[1]);
          const uint32_t h1 = pack_bf16(rem[2], rem[3]);
          *reinterpret_cast<uint2*>(dst + p * kPS) = make_uint2(h0, h1);
          rem[0] -= bf16_value(h0, 0);  // exact: the bits below the part
          rem[1] -= bf16_value(h0, 1);
          rem[2] -= bf16_value(h1, 0);
          rem[3] -= bf16_value(h1, 1);
        }
      }
      b = split;
    }
    __syncthreads();  // the widened codes (and split parts) are written
    wire::mma_tile<MT, NT, kBK, L::kParts, kBK, BN>(acc, wide, b,
                                                    warp * 8 * NT, kBK * BN);
  }

  // y = round_out(acc * scale), once
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * i + (lane >> 2) + 8 * h;
      if (m >= M) continue;
      const float s = scales[m];
      TO* row = y + (size_t)m * D;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + warp * 8 * NT + 8 * j + 2 * (lane & 3);
        const float v0 = __fmul_rn(acc[i][j][2 * h], s);
        const float v1 = __fmul_rn(acc[i][j][2 * h + 1], s);
        if (D % 2 == 0) {
          if (n < D) store2<TO>(row + n, v0, v1);
        } else {
          if (n < D) row[n] = rt::from_f<TO>(v0);
          if (n + 1 < D) row[n + 1] = rt::from_f<TO>(v1);
        }
      }
    }
}

template <int MT, int NT, typename TW, typename TO>
cudaError_t launch(const int8_t* codes, const float* scales, const void* w,
                   void* y, int M, int N, int D, int vec_a, int vec_b,
                   int smem_bytes, cudaStream_t stream) {
  constexpr int BM = 16 * MT, BN = 32 * NT;
  using L = Layout<BM, BN, TW>;
  if (smem_bytes != L::kBytes) return cudaErrorInvalidValue;
  auto kernel = dequant_matmul_kernel<MT, NT, TW, TO>;
  cudaError_t e = rt::allow_smem(kernel, L::kBytes);
  if (e == cudaSuccess)  // as many blocks an SM as the shared memory holds
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + BM - 1) / BM, (D + BN - 1) / BN);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      codes, scales, static_cast<const TW*>(w), static_cast<TO*>(y), M, N, D,
      vec_a, vec_b);
  return cudaGetLastError();
}

template <typename TW, typename TO>
cudaError_t by_tile(int block_m, int block_n, const int8_t* codes,
                    const float* scales, const void* w, void* y, int M, int N,
                    int D, int vec_a, int vec_b, int smem, cudaStream_t s) {
  if (block_m == 64 && block_n == 128)
    return launch<4, 4, TW, TO>(codes, scales, w, y, M, N, D, vec_a, vec_b,
                                smem, s);
  if (block_m == 64 && block_n == 64)
    return launch<4, 2, TW, TO>(codes, scales, w, y, M, N, D, vec_a, vec_b,
                                smem, s);
  if (block_m == 32 && block_n == 64)
    return launch<2, 2, TW, TO>(codes, scales, w, y, M, N, D, vec_a, vec_b,
                                smem, s);
  if (block_m == 16 && block_n == 64)
    return launch<1, 2, TW, TO>(codes, scales, w, y, M, N, D, vec_a, vec_b,
                                smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous tensors: codes int8 [M, N], scales f32 [M], w [N, D] (bf16 when
// w_bf16, else f32), y [M, D] (bf16 when out_bf16, else f32). block_m x
// block_n is the output tile, vec_a / vec_b choose 16-byte copies of the
// codes / of w, and smem_bytes is the plan's dynamic shared memory, which
// must equal the kernel's own layout (kernels/wire_plan.py). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a tile or layout the
// kernel does not have.
extern "C" int dequant_matmul_launch(const int8_t* codes, const float* scales,
                                     const void* w, void* y, int M, int N,
                                     int D, int w_bf16, int out_bf16,
                                     int block_m, int block_n, int vec_a,
                                     int vec_b, int smem_bytes,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return out_bf16
               ? by_tile<bf16, bf16>(block_m, block_n, codes, scales, w, y, M,
                                     N, D, vec_a, vec_b, smem_bytes, s)
               : by_tile<bf16, float>(block_m, block_n, codes, scales, w, y,
                                      M, N, D, vec_a, vec_b, smem_bytes, s);
  return out_bf16
             ? by_tile<float, bf16>(block_m, block_n, codes, scales, w, y, M,
                                    N, D, vec_a, vec_b, smem_bytes, s)
             : by_tile<float, float>(block_m, block_n, codes, scales, w, y, M,
                                     N, D, vec_a, vec_b, smem_bytes, s);
}
