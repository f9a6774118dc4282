// Hopper (sm_90a) kernel for the Pallas TPU kernel rglru_scan (replaces
// src/repro/kernels/rglru_scan.py:42, pallas_call at :53, body _kernel at
// :23): the RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over
// a, b, h of shape [B, S, D] in float32, with an optional initial carry
// h0 [B, D] (zeros when absent).
//
// What it computes, as the TPU kernel does: every step is one f32 multiply
// and one f32 add, rounded separately. The multiply-add is written with
// __fmul_rn / __fadd_rn so nvcc cannot contract it into an FMA: the
// reference (and the plain PyTorch version, two eager ops) rounds the
// product before the add, and the port matches it bit for bit. The TPU
// kernel folds h0 into b[:, 0] on the host (b_0 + a_0 * h0, the same f32
// expression as the first step here); this kernel reads h0 directly.
//
// Why time is not split: a chunked or parallel-prefix scan combines the
// steps' (a, b) pairs in another association, (a2 a1) h + (a2 b1 + b2)
// instead of a2 (a1 h + b1) + b2, which rounds differently and would lose
// the bit-for-bit contract. So every channel walks time in order, and the
// parallelism comes from channels and from bytes in flight.
//
// Bound: bytes. Every element of a and b is read once and every h written
// once (12 bytes a step a channel, plus h0), against 2 flops. Design: a
// block owns a tile of C consecutive channels (C = 8, 16 or 32: rows of
// 32-128 bytes) of one batch row, so B * ceil(D / C) blocks cover the card
// (kernels/rglru_scan.py::scan_plan picks C and the steps a stage T). The
// tile streams through a ring of K = kStages shared-memory slots
// of T steps x C channels (a, then b), with two warps:
// - the copy warp fills slot (s + K - 2) % K with 16-byte cp.async copies
//   (4-byte ones when D is not a multiple of 4 or a row is not 16-byte
//   aligned), one commit group a stage, K - 2 stages ahead, and writes the
//   h rows of the stage scanned last round out of their slot with stores
//   of the same width by all 32 lanes;
// - the scan warp's lane c < C walks its channel through the current
//   stage: it reads kChunk steps of a and b into registers (they do not
//   depend on the carry), runs the dependent chain and writes each h_t
//   over the a_t it came from.
// A __syncthreads a stage hands the slots over. Stores straight from the
// chain (one C-float row segment a step from C lanes) were the limit in
// probes on the card, which is why h goes out staged. A short S is one
// stage with every load issued at once; ragged D (a last tile past D) and
// ragged S (a last stage shorter than T) are guarded. One launch a call.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 2 * kWarp;  // warp 0 scans, warp 1 copies
constexpr int kChunk = 16;   // steps whose shared-memory reads issue together
// ring depth (kernels/rglru_scan.py::STAGES): the slot scanned, the slot
// stored and kStages - 2 filling
constexpr int kStages = 4;

// 4-byte asynchronous copy global -> shared (cp.async.ca), for rows that
// are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Copy n steps of the tile (global rows row0 .. row0 + n - 1 of the
// [B * S, D] view, channels d0 .. d0 + C - 1) of a and b into one ring
// slot ([n][C] floats each), V floats a copy; copies past D are skipped.
template <int C, int V>
__device__ __forceinline__ void load_stage(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float* sa, float* sb, size_t row0,
                                           int n, int d0, int D, int lane) {
  constexpr int kPerRow = C / V;
  const int total = n * kPerRow;
  for (int j = lane; j < total; j += kWarp) {
    const int t = j / kPerRow;
    const int q = (j % kPerRow) * V;
    if (d0 + q >= D) continue;
    const size_t g = (row0 + t) * (size_t)D + d0 + q;
    if constexpr (V == 4) {
      rt::cp_async16(sa + t * C + q, a + g);
      rt::cp_async16(sb + t * C + q, b + g);
    } else {
      cp_async4(sa + t * C + q, a + g);
      cp_async4(sb + t * C + q, b + g);
    }
  }
}

// Write n scanned steps of the tile ([n][C] floats of h in a slot) to
// global rows row0 .. row0 + n - 1, V floats a store; past D skipped.
template <int C, int V>
__device__ __forceinline__ void store_stage(float* __restrict__ h,
                                            const float* sh, size_t row0,
                                            int n, int d0, int D, int lane) {
  constexpr int kPerRow = C / V;
  const int total = n * kPerRow;
  for (int j = lane; j < total; j += kWarp) {
    const int t = j / kPerRow;
    const int q = (j % kPerRow) * V;
    if (d0 + q >= D) continue;
    float* g = h + (row0 + t) * (size_t)D + d0 + q;
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(g) =
          *reinterpret_cast<const float4*>(sh + t * C + q);
    } else {
      *g = sh[t * C + q];
    }
  }
}

// grid (ceil(D / C), B), two warps a block; dynamic shared memory
// 2 * min(kStages, ceil(S / T)) * T * C floats: the a slots (h written
// over them), then the b slots. Slot s % kStages < that count for every
// stage s.
template <int C, int V>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      int S, int D, int T) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int d0 = blockIdx.x * C;
  const int bi = blockIdx.y;
  const int n_st = (S + T - 1) / T;
  const int slot_len = T * C;
  float* ring_a = smem;
  float* ring_b = smem + (size_t)min(kStages, n_st) * slot_len;
  const size_t row_b = (size_t)bi * S;
  auto slot = [&](int s) { return (s % kStages) * slot_len; };
  auto steps = [&](int s) { return min(T, S - s * T); };
  auto fill = [&](int s) {
    load_stage<C, V>(a, b, ring_a + slot(s), ring_b + slot(s),
                     row_b + (size_t)s * T, steps(s), d0, D, lane);
  };

  const int d = d0 + lane;
  const bool scan_lane = warp == 0 && lane < C;
  const bool own = scan_lane && d < D;
  float carry = (own && h0 != nullptr) ? __ldg(h0 + (size_t)bi * D + d) : 0.f;
  if (warp == 1) {
    // stages 0 .. kStages-3 in flight, one commit group each; stage 0 landed
    for (int s = 0; s < kStages - 2; ++s) {
      if (s < n_st) fill(s);
      rt::cp_async_commit();
    }
    rt::cp_async_wait<kStages - 3>();
  }
  for (int s = 0; s <= n_st; ++s) {
    // stage s has landed and stage s - 1 is scanned
    __syncthreads();
    if (warp == 0) {
      if (s < n_st && scan_lane) {
        float* sa = ring_a + slot(s) + lane;
        const float* sb = ring_b + slot(s) + lane;
        const int n = steps(s);
        int u = 0;
        for (; u + kChunk <= n; u += kChunk) {
          float av[kChunk], bv[kChunk];
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            av[k] = sa[(u + k) * C];
            bv[k] = sb[(u + k) * C];
          }
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            carry = __fadd_rn(__fmul_rn(av[k], carry), bv[k]);
            sa[(u + k) * C] = carry;
          }
        }
        for (; u < n; ++u) {
          carry = __fadd_rn(__fmul_rn(sa[u * C], carry), sb[u * C]);
          sa[u * C] = carry;
        }
      }
    } else {
      if (s > 0)
        store_stage<C, V>(h, ring_a + slot(s - 1),
                          row_b + (size_t)(s - 1) * T, steps(s - 1), d0, D,
                          lane);
      // refill the slot stage s - 2 used (scanned two rounds ago, stored
      // last round); one group a stage, empty past the end, so stage s + 1
      // is complete once at most kStages - 3 groups are pending
      if (s + kStages - 2 < n_st) fill(s + kStages - 2);
      rt::cp_async_commit();
      rt::cp_async_wait<kStages - 3>();
    }
  }
}

template <int C, int V>
cudaError_t launch(const float* a, const float* b, const float* h0, float* h,
                   int B, int S, int D, int T, cudaStream_t stream) {
  const int slots = min(kStages, (S + T - 1) / T);
  const size_t smem = 2 * (size_t)slots * T * C * sizeof(float);
  cudaError_t e = rt::allow_smem(rglru_scan_kernel<C, V>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((D + C - 1) / C, B);
  rglru_scan_kernel<C, V><<<grid, kThreads, smem, stream>>>(a, b, h0, h, S,
                                                            D, T);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_v(int C, const float* a, const float* b, const float* h0,
                     float* h, int B, int S, int D, int T,
                     cudaStream_t stream) {
  switch (C) {
    case 8: return launch<8, V>(a, b, h0, h, B, S, D, T, stream);
    case 16: return launch<16, V>(a, b, h0, h, B, S, D, T, stream);
    case 32: return launch<32, V>(a, b, h0, h, B, S, D, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous f32 tensors; h0 may be null. The plan (tile C of 8, 16 or 32
// channels, T steps a stage, V = 4 for 16-byte copies, which need D % 4 ==
// 0 and 16-byte aligned a, b and h, or 1) comes from
// kernels/rglru_scan.py::scan_plan. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, float* h, int B, int S,
                                 int D, int C, int T, int V, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || T < 1 ||
      (V == 4 && D % 4 != 0))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V == 4) return launch_v<4>(C, a, b, h0, h, B, S, D, T, st);
  if (V == 1) return launch_v<1>(C, a, b, h0, h, B, S, D, T, st);
  return cudaErrorInvalidValue;
}
