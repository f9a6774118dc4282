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
// jnp.round. bf16 inputs run on the tensor cores (mma.sync m16n8k16 with
// f32 accumulation): a product of two bf16 values is exact in f32, so only
// the summation order differs from the reference. f32 inputs are exact in
// neither bf16 nor TF32, so they stay on CUDA-core FMAs: an 8 x 4 register
// tile a thread, float4 shared-memory reads, k ascending in a block.
//
// Bound: bf16 at 512 rows, the bytes (x, w, codes: 2.4-3.6 MB at the
// wires' shapes) against 1.1-1.7 GFLOP at the bf16 peak, about even; f32,
// the operations at the f32 FMA peak. What holds the kernel back is
// neither: a cluster must hold whole rows for their absmax, so at 512 rows
// its row tile is 16 rows and every cluster streams all of w through L2
// (64 MB for qwen2.5-3b's wire), at what each block's cp.async stream and
// the blocks an SM holds allow.
//
// Design: the first port split K over blocks and wrote f32 partial sums (8
// MB at the bench shape) for a second launch to quantize; the TPU keeps its
// accumulator in VMEM and writes only codes and scales. Here a thread-block
// cluster plays the VMEM: its blocks (at most 8) cover one 16-row tile.
// Rank r takes column group r % G (tiles of 128, 256 or 320 columns in
// bf16, 256 in f32; a block walks col_tiles of them, so N up to 4096 is
// taken and N 640 is two tiles of 320, no padded pass) and depth slice
// r / G. The plan (kernels/wire_plan.py) picks the tile and the split that
// stream the fewest bytes an SM among those that give every SM a block and
// whose clusters the card holds at once (the occupancy API's count). Each
// block streams its x and w tiles through a 3-stage cp.async ring (16-byte
// copies into dense swizzled rows, element loads where a row breaks
// 16-byte alignment, zeros past the edges) and keeps its f32 tile of z in
// shared memory. Then, through distributed shared memory: each block sums
// one part of its group's columns over the depth slices in rank order (a
// fixed order: the result is deterministic), takes its rows' partial
// absmax and writes it into every rank's shared memory; after a second
// cluster barrier (after which no block touches another's memory) each
// block takes the max over ranks, forms the scale and writes the codes of
// its part; rank 0 writes the scales. Nothing but codes and scales reaches
// device memory: one device kernel a call.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "wire_tile.cuh"

namespace cg = cooperative_groups;
using rt::bf16;

namespace {

using wire::kThreads;

constexpr int kStages = 3;  // depth of the cp.async ring
constexpr int kBM = 16;     // rows of a block (one cluster's row tile)

// A bf16 tile is 32 NT columns (NT n-tiles of 8 a warp, on the tensor
// cores): 128 columns 64 deep, or 256 / 320 columns 32 deep. An f32 tile is
// 256 columns, 16 deep: thread (warp w, lane l) owns rows 8 (w & 1) + i,
// i < 8, and columns 128 (w >> 1) + 4 l + j, j < 4, so each w value read
// from shared memory feeds 8 FMAs.
template <typename T, int NT>
struct Layout {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kBK = kBf16 ? (NT == 4 ? 64 : 32) : 16;  // depth
  static constexpr int kBN = kBf16 ? 32 * NT : 256;  // columns of a tile
  static constexpr int kAcc = kBf16 ? 4 * NT : 32;   // accumulators a thread
  static constexpr int kStage = (kBM * kBK + kBK * kBN) * (int)sizeof(T);
  static int bytes(int col_tiles) {
    return kStages * kStage + kBM * col_tiles * kBN * 4;
  }
};

// the bf16 mainloop step: warp w's 16 x 8 NT columns
template <int NT>
__device__ __forceinline__ void step(float (&acc)[4 * NT], const bf16* xs,
                                     const bf16* ws) {
  using L = Layout<bf16, NT>;
  wire::mma_tile<1, NT, L::kBK, 1, L::kBK, L::kBN>(
      reinterpret_cast<float(&)[1][NT][4]>(acc), xs, ws,
      (threadIdx.x >> 5) * 8 * NT, 0);
}

// the f32 mainloop step: acc[4 i + j] += sum over k ascending of
// x[8 (w & 1) + i][k] * w[k][128 (w >> 1) + 4 l + j]
template <int NT>
__device__ __forceinline__ void step(float (&acc)[32], const float* xs,
                                     const float* ws) {
  using L = Layout<float, NT>;
  const int warp = threadIdx.x >> 5;
  const float* xr = xs + (warp & 1) * 8 * L::kBK;
  const float* wc = ws + (warp >> 1) * 128 + (threadIdx.x & 31) * 4;
#pragma unroll
  for (int k = 0; k < L::kBK; k += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)  // one broadcast load a row
      a[i] = *reinterpret_cast<const float4*>(xr + i * L::kBK + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b =
          *reinterpret_cast<const float4*>(wc + (k + kk) * L::kBN);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = kk == 0   ? a[i].x
                         : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z
                                   : a[i].w;
        acc[4 * i + 0] = fmaf(av, b.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(av, b.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(av, b.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(av, b.w, acc[4 * i + 3]);
      }
    }
  }
}

// acc -> z[16][zs] at column c0, from the bf16 step's fragments
template <int NT>
__device__ __forceinline__ void store_z(float* z, int zs, int c0,
                                        const float (&acc)[4 * NT]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)  // rows lane / 4 (+8), columns 2 (lane % 4)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      z[((lane >> 2) + 8 * (e >> 1)) * zs + c0 + warp * 8 * NT + 8 * j +
        2 * (lane & 3) + (e & 1)] = acc[4 * j + e];
}
// ... and from the f32 step's register tile
__device__ __forceinline__ void store_z_f32(float* z, int zs, int c0,
                                            const float (&acc)[32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(z + (8 * (warp & 1) + i) * zs + c0 +
                               (warp >> 1) * 128 + 4 * lane) =
        make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                    acc[4 * i + 3]);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    bq_kernel(const T* __restrict__ x, const T* __restrict__ w,
              int8_t* __restrict__ codes, float* __restrict__ scales, int M,
              int K, int N, int col_groups, int col_tiles, int k_slice,
              float qmax, int vec_a, int vec_b) {
  using L = Layout<T, NT>;
  constexpr int BK = L::kBK;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int G = col_groups, S = cs / G;
  const int g = rank % G, s = rank / G;
  const int m0 = blockIdx.x / cs * kBM;
  const int kb = s * k_slice, ke = min(K, kb + k_slice);
  const int nk = (ke - kb + BK - 1) / BK;
  constexpr int kBN = L::kBN;
  const int zs = col_tiles * kBN;     // z row stride: the group's columns
  const int cg0 = g * zs;             // the group's first column
  const int tiles = min(col_tiles, (N - cg0 + kBN - 1) / kBN);
  const int total = tiles * nk;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float pmax[8][kBM];      // each rank's partial row absmax
  float* z = reinterpret_cast<float*>(smem + kStages * L::kStage);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto fetch = [&](int i) {
    if (i < total) {
      T* xs = reinterpret_cast<T*>(smem + i % kStages * L::kStage);
      const int k0 = kb + i % nk * BK, n0 = cg0 + i / nk * kBN;
      wire::load_tile<kBM, BK, L::kBf16>(xs, x, K, m0, M, k0, ke, vec_a);
      wire::load_tile<BK, kBN, L::kBf16>(xs + kBM * BK, w, N, k0, ke, n0, N,
                                         vec_b);
    }
    rt::cp_async_commit();  // empty past the last tile: a fixed wait count
  };

  float acc[L::kAcc] = {};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);
  for (int i = 0; i < total; ++i) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; tile i - 1 is consumed
    fetch(i + kStages - 1);
    const T* xs = reinterpret_cast<const T*>(smem + i % kStages * L::kStage);
    step<NT>(acc, xs, xs + kBM * BK);
    if (i % nk == nk - 1) {  // the column tile's depth slice is summed
      if constexpr (L::kBf16)
        store_z<NT>(z, zs, i / nk * kBN, acc);
      else
        store_z_f32(z, zs, i / nk * kBN, acc);
#pragma unroll
      for (int e = 0; e < L::kAcc; ++e) acc[e] = 0.f;
    }
  }

  // this block's part of the group's columns: [lo, hi); warp w takes rows
  // w + 4 i, i < 4, lane l the columns lo + l + 32 j
  const int sub = ((zs + S - 1) / S + 3) / 4 * 4;
  const int lo = min(zs, s * sub), hi = min(min(zs, lo + sub), N - cg0);
  constexpr int kRW = kBM / (kThreads / 32);  // rows a warp
  cluster.sync();  // every block's z tiles are written
  {
    const float* zr[8];  // the group's depth slices, in rank order
#pragma unroll
    for (int t = 0; t < 8; ++t)
      zr[t] = cluster.map_shared_rank(z, t < S ? t * G + g : rank);
    float amax[kRW] = {};
    for (int c = lo + lane; c < hi; c += 32) {
      float v[kRW];
#pragma unroll
      for (int i = 0; i < kRW; ++i) v[i] = zr[0][(warp + 4 * i) * zs + c];
#pragma unroll
      for (int t = 1; t < 8; ++t)
        if (t < S) {
          float u[kRW];
#pragma unroll
          for (int i = 0; i < kRW; ++i)
            u[i] = zr[t][(warp + 4 * i) * zs + c];
#pragma unroll
          for (int i = 0; i < kRW; ++i) v[i] = __fadd_rn(v[i], u[i]);
        }
#pragma unroll
      for (int i = 0; i < kRW; ++i) {
        z[(warp + 4 * i) * zs + c] = v[i];  // only this block reads [lo, hi)
        amax[i] = fmaxf(amax[i], fabsf(v[i]));
      }
    }
    // this rank's partial maxima, into every rank's shared memory
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const float a = rt::warp_max(amax[i]);
      if (lane < cs)
        cluster.map_shared_rank(&pmax[0][0], lane)[rank * kBM + warp + 4 * i] =
            a;
    }
  }
  // every rank's partial maxima are in place, and no block reads another's
  // memory after this
  cluster.sync();
  {
    float scale[kRW];
#pragma unroll
    for (int i = 0; i < kRW; ++i)
      scale[i] = lane < cs ? pmax[lane][warp + 4 * i] : 0.f;
#pragma unroll
    for (int i = 0; i < kRW; ++i)
      scale[i] = __fdiv_rn(fmaxf(rt::warp_max(scale[i]), 1e-8f), qmax);
#pragma unroll
    for (int i = 0; i < kRW; ++i) {
      const int m = m0 + warp + 4 * i;
      if (m >= M) continue;
      int8_t* row = codes + (size_t)m * N + cg0;
      for (int c = lo + lane; c < hi; c += 32) {
        const float q =
            rintf(__fdiv_rn(z[(warp + 4 * i) * zs + c], scale[i]));
        row[c] = static_cast<int8_t>(fminf(fmaxf(q, -qmax), qmax));
      }
      if (rank == 0 && lane == 0) scales[m] = scale[i];
    }
  }
}

// the kernel's attributes, set before any launch or occupancy query
template <typename T, int NT>
cudaError_t prepare(int bytes) {
  cudaError_t e = rt::allow_smem(bq_kernel<T, NT>, bytes);
  if (e == cudaSuccess)  // as many blocks an SM as the shared memory holds
    e = cudaFuncSetAttribute(bq_kernel<T, NT>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

cudaLaunchConfig_t config(int blocks, int bytes, cudaStream_t stream,
                          cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int NT>
cudaError_t max_clusters(int cluster, int bytes, int* out) {
  cudaError_t e = prepare<T, NT>(bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster, bytes, 0, attr, cluster);
  return cudaOccupancyMaxActiveClusters(out, bq_kernel<T, NT>, &cfg);
}

template <typename T, int NT>
cudaError_t launch(const void* x, const void* w, int8_t* codes,
                   float* scales, int M, int K, int N, int cluster,
                   int col_groups, int col_tiles, int k_slice, float qmax,
                   int vec_a, int vec_b, int smem_bytes, cudaStream_t stream) {
  using L = Layout<T, NT>;
  const int bytes = L::bytes(col_tiles);
  if (smem_bytes != bytes || cluster < 1 || cluster > 8 ||
      cluster % col_groups != 0 || k_slice % L::kBK != 0)
    return cudaErrorInvalidValue;
  cudaError_t e = prepare<T, NT>(bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config((M + kBM - 1) / kBM * cluster, bytes, stream, attr, cluster);
  e = cudaLaunchKernelEx(&cfg, bq_kernel<T, NT>, static_cast<const T*>(x),
                         static_cast<const T*>(w), codes, scales, M, K, N,
                         col_groups, col_tiles, k_slice, qmax, vec_a, vec_b);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous tensors: x [M, K] and w [K, N] (both bf16 when is_bf16, else
// both f32), codes int8 [M, N], scales f32 [M]. The plan
// (kernels/wire_plan.py) gives the column tile's width (block_n: 128, 256
// or 320 in bf16, 256 in f32), the cluster size, its column groups, the
// column tiles a block walks, the depth of a slice, the copy forms of x
// and w and the dynamic shared memory, which must equal the kernel's own
// layout. Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan
// the kernel does not take.
extern "C" int bottleneck_quant_launch(const void* x, const void* w,
                                       int8_t* codes, float* scales, int M,
                                       int K, int N, int is_bf16, int block_n,
                                       int cluster, int col_groups,
                                       int col_tiles, int k_slice, float qmax,
                                       int vec_a, int vec_b, int smem_bytes,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BQ_ARGS                                                              \
  x, w, codes, scales, M, K, N, cluster, col_groups, col_tiles, k_slice,    \
      qmax, vec_a, vec_b, smem_bytes, s
  if (!is_bf16) return block_n == 256 ? launch<float, 8>(BQ_ARGS)
                                      : cudaErrorInvalidValue;
  switch (block_n) {
    case 128: return launch<bf16, 4>(BQ_ARGS);
    case 256: return launch<bf16, 8>(BQ_ARGS);
    case 320: return launch<bf16, 10>(BQ_ARGS);
  }
#undef BQ_ARGS
  return cudaErrorInvalidValue;
}

// How many clusters of `cluster` blocks with smem_bytes of dynamic shared
// memory each the card holds at once (cudaOccupancyMaxActiveClusters), for
// the instantiation the plan's tile picks; into *out. Returns the query's
// error.
extern "C" int bottleneck_quant_max_clusters(int is_bf16, int block_n,
                                             int cluster, int smem_bytes,
                                             int* out) {
  if (!is_bf16)
    return block_n == 256 ? max_clusters<float, 8>(cluster, smem_bytes, out)
                          : cudaErrorInvalidValue;
  switch (block_n) {
    case 128: return max_clusters<bf16, 4>(cluster, smem_bytes, out);
    case 256: return max_clusters<bf16, 8>(cluster, smem_bytes, out);
    case 320: return max_clusters<bf16, 10>(cluster, smem_bytes, out);
  }
  return cudaErrorInvalidValue;
}
