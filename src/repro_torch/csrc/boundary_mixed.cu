// Hopper (sm_90a) kernels for the two Pallas TPU kernels of
// src/repro/kernels/boundary_mixed.py:
//
//  * boundary_mixed_grouped (replaces boundary_mixed.py:196, pallas_call at
//    :237, body _kernel at :37): the mixed-mode bottleneck boundary, on the
//    rows in place. Row r of the [N, d] rows rides mode mode_idx[r / S]
//    (S rows a sequence). Mode 0 copies the row bit for bit; mode m >= 1
//    takes head m-1 of the bank: rmsnorm (f32) x head scale -> model dtype;
//    down-projection, each lane's f32 sum rounded to the model dtype (the
//    TPU's per-chunk barrier), lanes >= width zeroed; row-wise symmetric
//    quant -> dequant (rintf, half to even like jnp.round; skipped at bits
//    0) -> model dtype; up-projection with f32 accumulation -> model dtype.
//
//    The TPU needs mode-uniform row blocks for its scalar-prefetched weight
//    maps, so its dispatcher sorts and pads the rows into a grouped layout.
//    Here each block finds the rows of its mode itself: warp 0 compacts the
//    per-sequence mode vector with a ballot, in row order. No layout is built
//    on the host, and padding rows are never computed.
//
//    Bound: at decode (a few rows) the bank's weights dominate the bytes
//    (d x W down + W x d up: 4 MB in bf16 at qwen2.5-3b's d 2048, W 512), so
//    the call is memory bound, and the weights must be spread over every SM.
//    Two launches:
//      1) bm_down, a block per (mode, width tile of 16 mt lanes, K slice of
//         512, chunk of 32 rows): its rows' inverse rms (recomputed by each
//         block from a few KB of rows), the normed rows of its slice in
//         shared memory while the scale and the weight tile stream in with
//         cp.async, then f32 partial sums of the slice -> scratch [n_ks, N,
//         wmax]. At decode (mt 1) 32 x 4 = 128 blocks of 16 KB of weights
//         (qwen2.5-3b) and 40 x 5 = 200 (recurrentgemma-2b).
//      2) bm_up, a block per (mode 0..M, column tile of 16 mt, chunk of 32
//         rows): the up tile streams in while the block rebuilds its rows'
//         codes a warp a row (the slices summed in order, rounded, masked,
//         quantized; a few KB of partials from L2), then the up-projection
//         of its columns. Mode-0 blocks copy their rows' columns. At decode
//         128 / 160 column tiles a mode.
//    At a few rows each launch is a chain of dependent latencies (the mode
//    scan, the rows, the weight tile, the mma chain), not a stream of
//    bytes: every load of a phase is issued before any is used.
//    bf16 runs on the tensor cores, "swap-AB": mma.sync m16n8k16 with the
//    width or column axis on M and the real rows on N (ceil(rows / 8)
//    n-tiles). The normed rows and the dequantized codes are exact in bf16
//    (the reference rounds both through the model dtype), so they are legal
//    operands; both weight tiles are k-major ([d, W] and [W, d]), so their A
//    fragments come from ldmatrix.trans. f32 (the reduced configs) keeps
//    CUDA-core FMAs, no TF32, at any width the bank holds.
//
//    Every output is summed in an order fixed by d and the mode's width
//    alone: the down-projection's 512-deep slices one after another, and
//    within a slice (and across the up-projection's lanes) in bf16 four
//    fixed quarters of the 16-deep k-steps, one a warp, added in order, each
//    an mma chain in k order; in f32 one FMA chain in k order. The tile
//    width (mt) and the row chunks change which block computes a value,
//    never how, so a row's output is bit-identical whether it is called
//    alone or inside a pool.
//
//  * decode_tail_grouped (replaces boundary_mixed.py:143, pallas_call at
//    :187, body _tail_kernel at :96): final rms/layernorm (f32, + bias)
//    rounded through the model dtype, f32 logits against the block's LM head,
//    argmax with strict > and the lowest index among equal maxima
//    (= jnp.argmax).
//
//    Bound: streaming the head once (622 MB in bf16 at qwen2.5-3b's
//    [2048, 151936], 1.31 GB for recurrentgemma-2b's tied [256000, 2560]
//    table) against 2 * rows * d * V flops: bytes, at the few rows of a
//    decode tick. Three launches: the row norms (a block per real row); the
//    logits and a (max, lowest index) pair per row and block; a pass that
//    reduces the pairs with the same tie-break. With one head the rows are
//    read in place: the row count need not be a multiple of the row block,
//    and no row at or past it is read.
//
//    bf16 logits run on the tensor cores, "swap-AB": mma.sync m16n8k16
//    with the vocabulary on M and the rows on N, bf16 in and f32
//    accumulate. The normed rows are exact in bf16 (the reference rounds
//    them through the model dtype), so they are a legal operand; they sit
//    in shared memory, and only ceil(real rows / 8) n-tiles of 8 are
//    computed (the dispatcher passes the real rows of each block, so the
//    main path's 4 rows take one n-tile, not the 16 of the row block). One
//    persistent block per SM walks a contiguous run of 128-column vocab
//    slabs; the head streams through a 5-stage cp.async ring of 64-deep
//    tiles (about 70 KB in flight an SM) that flows across slab edges.
//    Beside the ring, shared memory holds 16 rows of a row block, or 8 (a
//    half of it) where no block has more real rows or 16 rows of a wide d
//    do not fit (internlm2-20b's 6144): each half then streams the head.
//    The dispatcher's plan (``tail_plan``) picks; it never changes a
//    value.
//    The untied [d, V] tile is k-major, so its A fragments come from
//    ldmatrix.trans; the tied [V, d] table is read in place, never copied,
//    its rows k-contiguous (plain ldmatrix). Rows in shared memory are
//    padded by 16 bytes so ldmatrix's eight row reads hit distinct banks.
//    Each slab's logits fold into (max, lowest index) pairs in registers.
//
//    f32 inputs (the reduced reference configs) keep CUDA-core FMAs with no
//    TF32: each block takes 512 columns for one 8-row block, keeps the
//    normed rows in shared memory and its logits in registers; a tied table
//    is read in place in the [d, V] layout's k order.
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

using rt::bf16;
using rt::cp_async16_or_zero;
using rt::from_f;
using rt::ldmatrix_x4;
using rt::mma_bf16;
using rt::round_t;
using rt::to_f;

namespace {

constexpr int kThreads = 128;  // threads of the boundary kernels (4 warps)
constexpr int kBR = 32;        // rows of a boundary block (4 n-tiles of 8)
constexpr int kKS = 512;       // depth of a K slice of the down-projection
constexpr int kG = 5;          // groups of 4 code lanes a lane loads at once
constexpr int kTT = 256;       // threads of the tail's logit kernel
constexpr int kVT = 2 * kTT;   // vocab columns per tail block (two a thread)

// 16 bytes of floats stored as 8 bf16 (rounded to nearest even) or 4 f32
__device__ __forceinline__ void store16(bf16* p, const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// 16 bytes held in registers as floats: 8 bf16 or 4 f32
template <typename T>
__device__ __forceinline__ void u4_to_f(uint4 u, float* out);
template <>
__device__ __forceinline__ void u4_to_f<bf16>(uint4 u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void u4_to_f<float>(uint4 u, float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// ---------------------------------------------------------------------------
// boundary: the rows of one mode
// ---------------------------------------------------------------------------

// The reference's reading of a mode value: 0 is raw, anything else the head
// clamp(v - 1, 0, M - 1), i.e. mode clamp(v, 1, M)
__device__ __forceinline__ int mode_of(int v, int M) {
  return v == 0 ? 0 : min(max(v, 1), M);
}

// Rows r0 .. r0 + kBR - 1 of mode m, counted in row order: sequence b holds
// rows b*S .. b*S + S - 1, and the mode's sequences come in order of b.
// Writes their row indices to rows[] and returns the mode's row count (a
// block-wide call). Warp 0 compacts the mode vector 32 sequences at a time.
__device__ int mode_rows(const int* __restrict__ mode_idx, int B, int S,
                         int M, int m, int r0, int* rows) {
  __shared__ int s_count;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int q0 = r0 / S, q1 = (r0 + kBR - 1) / S;  // ranks that hold them
    int count = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const bool hit = b < B && mode_of(mode_idx[b], M) == m;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      const int rank = count + __popc(bal & ((1u << lane) - 1u));
      if (hit && rank >= q0 && rank <= q1) {
        const int lo = max(rank * S - r0, 0);
        const int hi = min(rank * S + S - r0, kBR);
        for (int j = lo; j < hi; ++j) rows[j] = b * S + r0 + j - rank * S;
      }
      count += __popc(bal);
    }
    if (lane == 0) s_count = count * S;
  }
  __syncthreads();
  return s_count;
}

// The boundary's tensor-core product: for each m-tile t < mt (16 columns of
// the k-major tile ``tile`` [kp][ts] at column 16t) against the block's rows
// ``rsm`` [16 * ceil(nr / 16)][rs] (k-contiguous; rows past nr zero), over
// kp (a multiple of 16) in four fixed quarters of its 16-deep k-steps, one
// a warp, each an mma chain in k order. A quarter's f32 sums land in
// red[t][quarter][row][16] for the caller to add in quarter order: a fixed
// order, the same for every row and every mt.
__device__ __forceinline__ void mma_quarters(const bf16* tile, int ts,
                                             const bf16* rsm, int rs, int kp,
                                             int mt, int nr, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, rr = lane & 7;
  const int ntiles = (nr + 7) >> 3;
  const int ns = kp >> 4, s0 = warp * ns / 4, s1 = (warp + 1) * ns / 4;
  for (int t = 0; t < mt; ++t) {
    // thread: columns 16t + lane/4 (+8) x rows nt*8 + (lane%4)*2 + {0, 1}
    float acc[kBR / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBR / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll 4
    for (int st = s0; st < s1; ++st) {
      const int kk = st * 16;
      uint32_t a[4];
      ldmatrix_x4<true>(a, tile + (kk + (q >> 1) * 8 + rr) * ts + t * 16 +
                               (q & 1) * 8);
#pragma unroll
      for (int p = 0; p < kBR / 16; ++p)
        if (2 * p < ntiles) {
          uint32_t b[4];  // rows 16p + 0-7: b[0], b[1]; + 8-15: b[2], b[3]
          ldmatrix_x4<false>(b, rsm + (p * 16 + (q >> 1) * 8 + rr) * rs + kk +
                                    (q & 1) * 8);
          mma_bf16(acc[2 * p], a, b[0], b[1]);
          if (2 * p + 1 < ntiles) mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
        }
    }
    float* out = red + (size_t)(t * 4 + warp) * kBR * 16;
#pragma unroll
    for (int nt = 0; nt < kBR / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = nt * 8 + (lane & 3) * 2 + (i & 1);
        if (r < nr) out[r * 16 + (lane >> 2) + (i >> 1) * 8] = acc[nt][i];
      }
  }
}

// the four quarters of red[t][.][r][c], added in order
__device__ __forceinline__ float quarters_sum(const float* red, int t, int r,
                                             int c) {
  const float* p = red + ((size_t)t * 4 * kBR + r) * 16 + c;
  return ((p[0] + p[kBR * 16]) + p[2 * kBR * 16]) + p[3 * kBR * 16];
}

// ---------------------------------------------------------------------------
// boundary: 1) row norms + the down-projection's partial sums of one slice
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bm_down(const T* __restrict__ x, const int* __restrict__ mode_idx, int B,
            int S, const T* __restrict__ down_w,
            const T* __restrict__ norm_scale, const int* __restrict__ width_t,
            int M, float* __restrict__ partial, int d, int wmax, int mt,
            int n_ks) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int rows[kBR];
  __shared__ float inv[kBR];
  const int hid = blockIdx.x, m = hid + 1;
  const int wt = 16 * mt, l0 = blockIdx.y * wt;  // this block's lanes
  const int ks = blockIdx.z % n_ks, r0 = (blockIdx.z / n_ks) * kBR;
  const int width = width_t[hid];  // in flight with the mode scan
  const int n_m = mode_rows(mode_idx, B, S, M, m, r0, rows);
  if (l0 >= width || r0 >= n_m) return;  // lanes past the width; no rows
  const int nr = min(kBR, n_m - r0), r16 = (nr + 15) & ~15;
  const int N = B * S;
  const int k0 = ks * kKS, kn = min(kKS, d - k0);
  const int kp = (kn + 15) & ~15;  // depth computed, zero-padded to 16
  const int ws = wt + E, hs = kKS + E;  // padded rows: distinct banks
  T* wsm = reinterpret_cast<T*>(smem_raw);  // [kKS][ws] weight tile
  T* hsm = wsm + kKS * ws;                  // [kBR][hs] normed rows
  T* ssm = hsm + kBR * hs;                  // [kKS] the head's scale
  float* red = reinterpret_cast<float*>(ssm + kKS);  // [mt][4][kBR][16]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the scale slice, then the weight tile, stream in while the rows' norms
  // are taken
  const T* sc = norm_scale + (size_t)hid * d + k0;
  for (int c = threadIdx.x * E; c < kp; c += kThreads * E)
    cp_async16_or_zero(ssm + c, c < kn ? sc + c : sc, c < kn);
  rt::cp_async_commit();
  const T* w = down_w + ((size_t)hid * d + k0) * wmax + l0;
  const int vr = wt / E;  // 16-byte vectors a tile row; divides kThreads
  const int c = (threadIdx.x % vr) * E;
  for (int k = threadIdx.x / vr; k < kp; k += kThreads / vr) {
    const bool ok = k < kn && l0 + c < wmax;
    cp_async16_or_zero(wsm + k * ws + c, ok ? w + (size_t)k * wmax + c : w,
                       ok);
  }
  rt::cp_async_commit();

  // inverse rms of each row over all of d: a warp a row, eight vectors a
  // lane in flight, summed in k order (the same lanes and order whatever
  // the row's slot; the zeros past d add nothing)
  for (int i = warp; i < nr; i += kThreads / 32) {
    const T* xr = x + (size_t)rows[i] * d;
    float ss = 0.f;
    for (int kb = lane * E; kb < d; kb += 8 * 32 * E) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = kb + u * 32 * E;
        v[u] = k < d ? *reinterpret_cast<const uint4*>(xr + k)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float f[E];
        u4_to_f<T>(v[u], f);
#pragma unroll
        for (int j = 0; j < E; ++j) ss += f[j] * f[j];
      }
    }
    ss = rt::warp_sum(ss);
    if (lane == 0) inv[i] = rsqrtf(ss / (float)d + 1e-6f);
  }
  rt::cp_async_wait<1>();  // the scale slice has landed
  __syncthreads();
  // (x * inv) * scale of this slice, rounded to the model dtype; rows past
  // the block's and depths past d are zeros
  const int hv = kp / E;
#pragma unroll 2
  for (int i = threadIdx.x; i < r16 * hv; i += kThreads) {
    const int r = i / hv, c = (i - r * hv) * E;
    float h[E];
#pragma unroll
    for (int j = 0; j < E; ++j) h[j] = 0.f;
    if (r < nr && c < kn) {
      float xv[E], sv[E];
      rt::smem16_to_f(x + (size_t)rows[r] * d + k0 + c, xv);
      rt::smem16_to_f(ssm + c, sv);
#pragma unroll
      for (int j = 0; j < E; ++j) h[j] = xv[j] * inv[r] * sv[j];
    }
    store16(hsm + r * hs + c, h);
  }
  rt::cp_async_wait<0>();
  __syncthreads();

  if constexpr (sizeof(T) == 2) {
    mma_quarters(wsm, ws, hsm, hs, kp, mt, nr, red);
    __syncthreads();
    for (int i = threadIdx.x; i < mt * nr * 16; i += kThreads) {
      const int t = i / (nr * 16), r = (i >> 4) - t * nr, cc = i & 15;
      const int l = l0 + t * 16 + cc;
      if (l < wmax)
        partial[((size_t)ks * N + rows[r]) * wmax + l] =
            quarters_sum(red, t, r, cc);
    }
  } else {
    // f32: each output an FMA chain over the slice in k order
    for (int o = threadIdx.x; o < nr * wt; o += kThreads) {
      const int r = o / wt, c = o - r * wt;
      float acc = 0.f;
      for (int k = 0; k < kn; ++k)
        acc += to_f(hsm[r * hs + k]) * to_f(wsm[k * ws + c]);
      if (l0 + c < wmax)
        partial[((size_t)ks * N + rows[r]) * wmax + l0 + c] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// boundary: 2) codes (slices summed, rounded, masked, quantized) + the
//    up-projection of one column tile; mode 0 copies
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bm_up(const T* __restrict__ x, const int* __restrict__ mode_idx, int B,
          int S, const T* __restrict__ up_w, const int* __restrict__ width_t,
          const int* __restrict__ bits_t, int M,
          const float* __restrict__ partial, T* __restrict__ out, int d,
          int wmax, int mt, int n_ks, int kmax) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int rows[kBR];
  const int m = blockIdx.x, hid = max(m - 1, 0);
  const int ct = 16 * mt, c0 = blockIdx.y * ct, r0 = blockIdx.z * kBR;
  const int width = width_t[hid], bits = bits_t[hid];  // with the scan
  const int n_m = mode_rows(mode_idx, B, S, M, m, r0, rows);
  if (r0 >= n_m) return;
  const int nr = min(kBR, n_m - r0);
  const int vr = ct / E;
  if (m == 0) {  // the raw code z crosses unchanged
    for (int i = threadIdx.x; i < nr * vr; i += kThreads) {
      const int r = i / vr, c = c0 + (i - r * vr) * E;
      if (c < d) {
        const size_t o = (size_t)rows[r] * d + c;
        *reinterpret_cast<uint4*>(out + o) =
            *reinterpret_cast<const uint4*>(x + o);
      }
    }
    return;
  }
  const int kp = (width + 15) & ~15;  // lanes of the up-projection
  const int us = ct + E, zs = kmax + E;
  T* usm = reinterpret_cast<T*>(smem_raw);  // [kmax][us] up tile
  T* zsm = usm + kmax * us;                 // [kBR][zs] dequantized codes
  float* red = reinterpret_cast<float*>(zsm + kBR * zs);  // [mt][4][kBR][16]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = B * S;

  // the up tile streams in while the codes are rebuilt
  const T* up = up_w + (size_t)hid * wmax * d + c0;
  const int c = (threadIdx.x % vr) * E;  // vr divides kThreads
  for (int k = threadIdx.x / vr; k < kp; k += kThreads / vr) {
    const bool ok = k < wmax && c0 + c < d;
    cp_async16_or_zero(usm + k * us + c, ok ? up + (size_t)k * d + c : up,
                       ok);
  }
  rt::cp_async_commit();

  // a warp a row: z = the slices' sums in order, rounded to the model
  // dtype, lanes >= width zero (each lane kG groups of four lanes, four
  // slices in flight); the row's |z| maximum; then the codes and their
  // dequantized values, each lane on the lanes it wrote
  const size_t sl = (size_t)N * wmax;  // one slice of the partial sums
  const float qm = (float)max((1 << (max(bits, 1) - 1)) - 1, 1);
  for (int r = warp; r < nr; r += kThreads / 32) {
    const float* pr = partial + (size_t)rows[r] * wmax;
    T* zr = zsm + r * zs;
    float mx = 0.f;
    for (int j0 = lane * 4; j0 < kp; j0 += kG * 32 * 4) {
      float4 acc[kG];
#pragma unroll
      for (int u = 0; u < kG; ++u) {  // j < width: j + 3 < wmax (8 | wmax)
        const int j = j0 + u * 32 * 4;
        acc[u] = j < width ? *reinterpret_cast<const float4*>(pr + j)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int ks = 1; ks < n_ks; ks += 4) {
        float4 t[4][kG];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int u = 0; u < kG; ++u) {
            const int j = j0 + u * 32 * 4;
            t[q][u] = j < width && ks + q < n_ks
                          ? *reinterpret_cast<const float4*>(
                                pr + (ks + q) * sl + j)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ks + q < n_ks)
#pragma unroll
            for (int u = 0; u < kG; ++u) acc[u] = add4(acc[u], t[q][u]);
      }
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        const int j = j0 + u * 32 * 4;
        if (j >= kp) continue;
        const float a4[4] = {acc[u].x, acc[u].y, acc[u].z, acc[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float z = j + e < width ? round_t<T>(a4[e]) : 0.f;
          zr[j + e] = from_f<T>(z);
          mx = fmaxf(mx, fabsf(z));
        }
      }
    }
    if (bits == 0) continue;
    const float scale = fmaxf(rt::warp_max(mx), 1e-8f) / qm;
    for (int j0 = lane * 4; j0 < kp; j0 += 32 * 4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        if (j < width)
          zr[j] = from_f<T>(
              fminf(fmaxf(rintf(to_f(zr[j]) / scale), -qm), qm) * scale);
      }
  }

  if constexpr (sizeof(T) == 2) {
    const int r16 = (nr + 15) & ~15;  // rows an ldmatrix pair reads: zeros
    for (int r = nr + warp; r < r16; r += kThreads / 32)
      for (int k = lane * 8; k < kp; k += 32 * 8)
        *reinterpret_cast<uint4*>(zsm + r * zs + k) = make_uint4(0, 0, 0, 0);
    rt::cp_async_wait<0>();
    __syncthreads();
    mma_quarters(usm, us, zsm, zs, kp, mt, nr, red);
    __syncthreads();
    for (int i = threadIdx.x; i < mt * nr * 16; i += kThreads) {
      const int t = i / (nr * 16), r = (i >> 4) - t * nr, cc = i & 15;
      const int col = c0 + t * 16 + cc;
      if (col < d)
        out[(size_t)rows[r] * d + col] = from_f<T>(quarters_sum(red, t, r, cc));
    }
  } else {
    rt::cp_async_wait<0>();
    __syncthreads();
    // f32: each output an FMA chain over the lanes in order (the lanes past
    // the width, zeros, add nothing)
    for (int o = threadIdx.x; o < nr * ct; o += kThreads) {
      const int r = o / ct, c = o - r * ct;
      if (c0 + c >= d) continue;
      float acc = 0.f;
      for (int k = 0; k < width; ++k)
        acc += to_f(zsm[r * zs + k]) * to_f(usm[k * us + c]);
      out[(size_t)rows[r] * d + c0 + c] = from_f<T>(acc);
    }
  }
}

template <typename T>
cudaError_t boundary_launch(const T* x, const int* mode_idx, int B, int S,
                            const T* down_w, const T* up_w,
                            const T* norm_scale, const int* width,
                            const int* bits, int M, float* partial, T* out,
                            int d, int wmax, int mt, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int n_ks = (d + kKS - 1) / kKS;
  const int n_rc = (B * S + kBR - 1) / kBR;
  const int t16 = 16 * mt;
  const size_t red = sizeof(float) * 4 * mt * kBR * 16;  // quarter sums
  const size_t smem1 = sizeof(T) * ((size_t)kKS * (t16 + E) +
                                    (size_t)kBR * (kKS + E) + kKS) + red;
  cudaError_t e = rt::allow_smem(bm_down<T>, smem1);
  if (e != cudaSuccess) return e;
  bm_down<T><<<dim3(M, (wmax + t16 - 1) / t16, n_ks * n_rc), kThreads, smem1,
               stream>>>(x, mode_idx, B, S, down_w, norm_scale, width, M,
                         partial, d, wmax, mt, n_ks);
  const int kmax = (wmax + 15) & ~15;
  const size_t smem2 =
      sizeof(T) * ((size_t)kmax * (t16 + E) + (size_t)kBR * (kmax + E)) + red;
  if ((e = rt::allow_smem(bm_up<T>, smem2)) != cudaSuccess) return e;
  bm_up<T><<<dim3(M + 1, (d + t16 - 1) / t16, n_rc), kThreads, smem2,
             stream>>>(x, mode_idx, B, S, up_w, width, bits, M, partial, out,
                       d, wmax, mt, n_ks, kmax);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode tail: 1) final norm of one row (a block per real row), rounded
//    through the model dtype; a null bias adds nothing
// ---------------------------------------------------------------------------
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = rt::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  __syncthreads();  // red is reused by the next sum
  return t;
}

template <typename T>
__global__ void tail_norm(const T* __restrict__ xp, const T* __restrict__ scale,
                          const T* __restrict__ bias, T* __restrict__ h, int d,
                          int layernorm) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* x = xp + row * d;
  float mu = 0.f;
  if (layernorm) {
    float s = 0.f;
#pragma unroll 4
    for (int k = threadIdx.x; k < d; k += blockDim.x) s += to_f(x[k]);
    mu = block_sum(s, red) / (float)d;
  }
  float s = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    const float v = to_f(x[k]) - mu;
    s += v * v;
  }
  const float iv = rsqrtf(block_sum(s, red) / (float)d + 1e-6f);
#pragma unroll 4
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    float y = (to_f(x[k]) - mu) * iv * to_f(scale[k]);
    if (bias != nullptr) y += to_f(bias[k]);
    h[row * d + k] = from_f<T>(y);
  }
}

// 8 consecutive floats (32 bytes, 16-byte aligned): the normed rows of
// one k (shared memory), or one sector of a tied head's row (device memory)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// ---------------------------------------------------------------------------
// decode tail: 2) f32 logits of one 512-column vocab tile + per-row argmax
// ---------------------------------------------------------------------------
template <bool kTied>
__global__ void tail_logits(const float* __restrict__ h,
                            const float* __restrict__ heads,
                            const int* __restrict__ hid_g,
                            float* __restrict__ pbest, int* __restrict__ pidx,
                            int d, int V, int ld, int n_real) {
  constexpr int R = 8;  // rows of an f32 row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hT = reinterpret_cast<float*>(smem_raw);  // [d][R]: rows at one k
  __shared__ float rb[R][kTT / 32];
  __shared__ int ri[R][kTT / 32];
  const int vt = blockIdx.x, g = blockIdx.y;
#pragma unroll 8
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, k = i - r * d;  // rows >= n_real are never read
    hT[k * R + r] = g * R + r < n_real ? h[((size_t)g * R + r) * d + k] : 0.f;
  }
  __syncthreads();
  const int c0 = vt * kVT + threadIdx.x, c1 = c0 + kTT;
  const bool ok0 = c0 < V, ok1 = c1 < V;
  const float* w = heads + (size_t)(hid_g != nullptr ? hid_g[g] : 0) * d * V;
  float a0[R], a1[R], hv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.f;
  if constexpr (kTied) {
    // [V, d]: columns c0 / c1 are rows of the table (a column past V reads
    // row 0 and is never compared), read one 32-byte sector at a time
    // from a 16-byte aligned start (checked by the wrapper)
    const float* r0 = w + (size_t)(ok0 ? c0 : 0) * d;
    const float* r1 = w + (size_t)(ok1 ? c1 : 0) * d;
    for (int k0 = 0; k0 < d; k0 += 8) {
      float w0[8], w1[8];
      load8(r0 + k0, w0);
      load8(r1 + k0, w1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        load8(hT + (k0 + j) * R, hv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a0[r] += hv[r] * w0[j];
          a1[r] += hv[r] * w1[j];
        }
      }
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < d; ++k) {
      const float* wk = w + (size_t)k * V;
      const float w0 = ok0 ? wk[c0] : 0.f;
      const float w1 = ok1 ? wk[c1] : 0.f;
      load8(hT + k * R, hv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        a0[r] += hv[r] * w0;
        a1[r] += hv[r] * w1;
      }
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    if (ok0) rt::arg_better(bv, bi, a0[r], c0);
    if (ok1) rt::arg_better(bv, bi, a1[r], c1);
    rt::warp_argmax(bv, bi);
    if (lane == 0) {
      rb[r][warp] = bv;
      ri[r][warp] = bi;
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float bv = rb[r][0];
    int bi = ri[r][0];
    for (int wi = 1; wi < kTT / 32; ++wi)
      rt::arg_better(bv, bi, rb[r][wi], ri[r][wi]);
    const size_t row = (size_t)g * R + r;
    pbest[row * ld + vt] = bv;
    pidx[row * ld + vt] = bi;
  }
}

// ---------------------------------------------------------------------------
// decode tail: 2') bf16 logits on the tensor cores + per-row argmax
// ---------------------------------------------------------------------------
constexpr int kMV = 128;     // vocab columns a slab (8 m-tiles of 16)
constexpr int kKC = 64;      // depth of one staged tile
constexpr int kStages = 5;   // cp.async ring
constexpr int kMT = 128;     // threads: 4 warps, 32 vocab columns each
constexpr int kPad = 8;      // bf16 padding of a shared-memory row (16 B)
constexpr int kRB = 16;      // rows of a bf16 row block (block_r)

template <bool kTied>
__host__ __device__ constexpr int stage_elems() {  // one staged tile, padded rows
  return kTied ? kMV * (kKC + kPad) : kKC * (kMV + kPad);
}

template <bool kTied>
size_t tail_mma_smem(int d, int rows_cap) {
  return sizeof(bf16) * ((size_t)rows_cap * (d + kPad) +
                         (size_t)kStages * stage_elems<kTied>());
}

// Block (x, y): the contiguous run of vocab slabs x of the rows_cap rows
// (16, or 8: a half) of row block y * rows_cap / 16 that start at row
// y * rows_cap. A slab's logits: acc[mt][nt] is the m16n8 tile of this
// warp's vocab columns warp*32 + mt*16 and rows nt*8; thread t holds vocab
// (t/4, +8) x rows (t%4)*2 + {0, 1}. Rows past the block's real rows are
// zero and never compared; a block with none writes (-inf, 0) pairs. With
// a cap of 8 the second ldmatrix pair repeats row 7, unused (one n-tile).
template <bool kTied>
__global__ void __launch_bounds__(kMT)
    tail_mma(const bf16* __restrict__ h, const bf16* __restrict__ heads,
             const int* __restrict__ hid_g, const int* __restrict__ rows_g,
             int n_real, float* __restrict__ pbest, int* __restrict__ pidx,
             int ld, int d, int V, int n_slabs, int rows_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float rb[kMT / 32][kRB];
  __shared__ int ri[kMT / 32][kRB];
  const int g = blockIdx.y * rows_cap / kRB, tid = threadIdx.x;
  const int r0 = blockIdx.y * rows_cap;  // this block's first row
  const int warp = tid >> 5, lane = tid & 31;
  const int nrows = min(max((rows_g != nullptr ? g * kRB + rows_g[g] : n_real)
                                - r0, 0), rows_cap);
  if (nrows == 0) {
    if (tid < rows_cap) {
      pbest[(size_t)(r0 + tid) * ld + blockIdx.x] = -INFINITY;
      pidx[(size_t)(r0 + tid) * ld + blockIdx.x] = 0;
    }
    return;
  }
  const int ntiles = (nrows + 7) >> 3;
  const int per = n_slabs / gridDim.x, extra = n_slabs % gridDim.x;
  const int s0 = blockIdx.x * per + min((int)blockIdx.x, extra);
  const int ns = per + ((int)blockIdx.x < extra ? 1 : 0);
  const int hs = d + kPad;
  bf16* hsm = reinterpret_cast<bf16*>(smem_raw);  // [rows_cap][d + pad]
  bf16* ring = hsm + rows_cap * hs;
  constexpr int kSE = stage_elems<kTied>();
  const bf16* w = heads + (size_t)(hid_g != nullptr ? hid_g[g] : 0) * d * V;

  // the block's normed rows; rows >= nrows are zeros
  const int c8 = d / 8;
  for (int i = tid; i < rows_cap * c8; i += kMT) {
    const int r = i / c8, c = i - r * c8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nrows)
      v = *reinterpret_cast<const uint4*>(h + ((size_t)r0 + r) * d + c * 8);
    *reinterpret_cast<uint4*>(hsm + r * hs + c * 8) = v;
  }

  const int nk = d / kKC, total = ns * nk;
  auto fetch = [&](int it) {
    if (it < total) {
      const int s = s0 + it / nk, k0 = (it % nk) * kKC;
      bf16* st = ring + (it % kStages) * kSE;
      if constexpr (kTied) {  // kMV table rows x kKC depth
        for (int i = tid; i < kMV * (kKC / 8); i += kMT) {
          const int r = i / (kKC / 8), c = i - r * (kKC / 8);
          const int v = s * kMV + r;
          cp_async16_or_zero(st + r * (kKC + kPad) + c * 8,
                             w + (size_t)(v < V ? v : 0) * d + k0 + c * 8,
                             v < V);
        }
      } else {  // kKC head rows x kMV columns
        for (int i = tid; i < kKC * (kMV / 8); i += kMT) {
          const int r = i / (kMV / 8), c = i - r * (kMV / 8);
          const int v = s * kMV + c * 8;
          cp_async16_or_zero(st + r * (kMV + kPad) + c * 8,
                             w + (size_t)(k0 + r) * V + (v < V ? v : 0),
                             v < V);
        }
      }
    }
    rt::cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) fetch(it);

  float acc[2][2][4];
  float best[2][2];
  int bidx[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      best[nt][j] = -INFINITY;
      bidx[nt][j] = INT_MAX;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) acc[mt][nt][2 * j] = acc[mt][nt][2 * j + 1] = 0.f;
    }
  // ldmatrix row addresses of this lane: matrix q = lane / 8, row lane % 8
  const int q = lane >> 3, rr = lane & 7;
  const bf16* b_base =
      hsm + min((q >> 1) * 8 + rr, rows_cap - 1) * hs + (q & 1) * 8;
  for (int it = 0; it < total; ++it) {
    rt::cp_async_wait<kStages - 2>();
    __syncthreads();            // tile `it` landed; tile it - 1 is consumed
    fetch(it + kStages - 1);    // refill the stage tile it - 1 used
    const bf16* st = ring + (it % kStages) * kSE;
    const int k0 = (it % nk) * kKC;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t b[4];  // rows 0-7: b[0], b[1]; rows 8-15: b[2], b[3]
      ldmatrix_x4<false>(b, b_base + k0 + kk);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m0 = warp * 32 + mt * 16;
        uint32_t a[4];
        if constexpr (kTied)  // [v][k]: matrices (v0-7,k0-7) (v8-15,k0-7) ...
          ldmatrix_x4<false>(a, st + (m0 + (q & 1) * 8 + rr) * (kKC + kPad) +
                                    kk + (q >> 1) * 8);
        else  // [k][v], transposed on load
          ldmatrix_x4<true>(a, st + (kk + (q >> 1) * 8 + rr) * (kMV + kPad) +
                                   m0 + (q & 1) * 8);
        mma_bf16(acc[mt][0], a, b[0], b[1]);
        if (ntiles > 1) mma_bf16(acc[mt][1], a, b[2], b[3]);
      }
    }
    if (it % nk == nk - 1) {  // slab done: fold its logits into the pairs
      const int vb = (s0 + it / nk) * kMV + warp * 32 + (lane >> 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int v = vb + mt * 16 + (i >> 1) * 8;
            if (v < V) rt::arg_better(best[nt][i & 1], bidx[nt][i & 1],
                                      acc[mt][nt][i], v);
            acc[mt][nt][i] = 0.f;
          }
    }
  }
  // pairs of the lanes that hold the same rows (equal lane % 4), then warps
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, best[nt][j], o);
        const int i = __shfl_xor_sync(0xffffffffu, bidx[nt][j], o);
        rt::arg_better(best[nt][j], bidx[nt][j], v, i);
      }
      if (lane < 4) {
        rb[warp][nt * 8 + lane * 2 + j] = best[nt][j];
        ri[warp][nt * 8 + lane * 2 + j] = bidx[nt][j];
      }
    }
  __syncthreads();
  if (tid < rows_cap) {
    float bv = -INFINITY;
    int bi = 0;
    if (tid < nrows) {
      bv = rb[0][tid];
      bi = ri[0][tid];
      for (int wi = 1; wi < kMT / 32; ++wi)
        rt::arg_better(bv, bi, rb[wi][tid], ri[wi][tid]);
    }
    pbest[(size_t)(r0 + tid) * ld + blockIdx.x] = bv;
    pidx[(size_t)(r0 + tid) * ld + blockIdx.x] = bi;
  }
}

// decode tail: 3) reduce the n per-block pairs of each row (a warp a row);
// row r's pairs sit at r * ld
__global__ void tail_reduce(const float* __restrict__ pbest,
                            const int* __restrict__ pidx, int* __restrict__ tok,
                            int rows, int n, int ld) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int j = lane; j < n; j += 32)
    rt::arg_better(bv, bi, pbest[(size_t)row * ld + j],
                   pidx[(size_t)row * ld + j]);
  rt::warp_argmax(bv, bi);
  if (lane == 0) tok[row] = bi;
}

// the rows a block holds (16, or 8: a row block is then two blocks, each
// streaming the head) come from the dispatcher's plan; about one block an
// SM
template <bool kTied>
cudaError_t tail_mma_launch(const void* hbuf, const void* heads, const int* hid,
                            const int* rows_g, int n_real, float* pbest,
                            int* pidx, int ld, int G, int d, int V, int n_sms,
                            int rows_cap, int* n_part, cudaStream_t stream) {
  if (rows_cap != 8 && rows_cap != kRB) return cudaErrorInvalidValue;
  // row blocks of rows_cap: those holding a real row
  const int gy = rows_g != nullptr ? G * (kRB / rows_cap)
                                   : (n_real + rows_cap - 1) / rows_cap;
  const int n_slabs = (V + kMV - 1) / kMV;
  const int gx = std::max(1, std::min(n_slabs, std::min(ld, n_sms / gy)));
  const size_t smem = tail_mma_smem<kTied>(d, rows_cap);
  cudaError_t e = rt::allow_smem(tail_mma<kTied>, smem);
  if (e != cudaSuccess) return e;
  tail_mma<kTied><<<dim3(gx, gy), kMT, smem, stream>>>(
      static_cast<const bf16*>(hbuf), static_cast<const bf16*>(heads), hid,
      rows_g, n_real, pbest, pidx, ld, d, V, n_slabs, rows_cap);
  *n_part = gx;
  return cudaSuccess;
}

template <bool kTied>
cudaError_t tail_logits_launch(const void* hbuf, const void* heads,
                               const int* hid, float* pbest, int* pidx, int G,
                               int d, int V, int n_vt, int ld, int n_real,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * 8 * d;
  cudaError_t e = rt::allow_smem(tail_logits<kTied>, smem);
  if (e != cudaSuccess) return e;
  tail_logits<kTied><<<dim3(n_vt, G), kTT, smem, stream>>>(
      static_cast<const float*>(hbuf), static_cast<const float*>(heads), hid,
      pbest, pidx, d, V, ld, n_real);
  return cudaSuccess;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

template <typename T, int R>
cudaError_t tail_launch(const void* xp, const void* heads, const void* scale,
                        const void* bias, const int* hid, const int* rows_g,
                        int n_real, void* hbuf, float* pbest, int* pidx,
                        int ld, int* tok, int G, int d, int V, int layernorm,
                        int tied, int rows_cap, cudaStream_t stream) {
  tail_norm<T><<<n_real, 256, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(hbuf), d, layernorm);
  int n_part = 0;
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    e = tied ? tail_mma_launch<true>(hbuf, heads, hid, rows_g, n_real, pbest,
                                     pidx, ld, G, d, V, sm_count(), rows_cap,
                                     &n_part, stream)
             : tail_mma_launch<false>(hbuf, heads, hid, rows_g, n_real, pbest,
                                      pidx, ld, G, d, V, sm_count(), rows_cap,
                                      &n_part, stream);
  } else {
    n_part = (V + kVT - 1) / kVT;
    if (n_part > ld) return cudaErrorInvalidValue;
    e = tied ? tail_logits_launch<true>(hbuf, heads, hid, pbest, pidx, G, d, V,
                                        n_part, ld, n_real, stream)
             : tail_logits_launch<false>(hbuf, heads, hid, pbest, pidx, G, d,
                                         V, n_part, ld, n_real, stream);
  }
  if (e != cudaSuccess) return e;
  tail_reduce<<<(n_real + 3) / 4, 128, 0, stream>>>(pbest, pidx, tok, n_real,
                                                   n_part, ld);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers;
// the scratch buffers come from the caller. Returns cudaGetLastError().
extern "C" int boundary_mixed_rows_launch(
    const void* x, const int* mode_idx, int B, int S, const void* down_w,
    const void* up_w, const void* norm_scale, const int* width,
    const int* bits, int M, float* partial, void* out, int d, int wmax,
    int mt, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return boundary_launch<bf16>(
        static_cast<const bf16*>(x), mode_idx, B, S,
        static_cast<const bf16*>(down_w), static_cast<const bf16*>(up_w),
        static_cast<const bf16*>(norm_scale), width, bits, M, partial,
        static_cast<bf16*>(out), d, wmax, mt, s);
  return boundary_launch<float>(
      static_cast<const float*>(x), mode_idx, B, S,
      static_cast<const float*>(down_w), static_cast<const float*>(up_w),
      static_cast<const float*>(norm_scale), width, bits, M, partial,
      static_cast<float*>(out), d, wmax, mt, s);
}

// ``tied``: heads is [H, V, d] (the embedding table) instead of [H, d, V].
// ``hid``: a head a row block, or null for head 0; ``bias``: null for none.
// ``pbest`` / ``pidx``: [G * R, ld] scratch, ld >= ceil(V / 128). Rows
// 0 .. n_real - 1 are normed, computed and reduced into ``tok``; no row at
// or past n_real is read, so ``xp`` may hold n_real rows, fewer than G * R.
// Real rows of row block g in bf16: ``rows_g[g]`` when given (then n_real
// is G * R), else min(n_real - g * R, R). The caller guarantees, in bf16,
// d % 64 == 0, V % 8 == 0 and 16-byte aligned heads; in f32, d a multiple
// of 8 and 16-byte aligned rows. bf16 only: ``rows_cap`` (8 or 16) is the
// rows a block keeps in shared memory (8: each row block runs as two
// halves); a plan whose shared memory the card refuses returns its error.
extern "C" int decode_tail_grouped_launch(
    const void* xp, const void* heads, const void* scale, const void* bias,
    const int* hid, void* hbuf, float* pbest, int* pidx, int* tok, int G,
    int d, int V, int layernorm, int tied, int is_bf16, const int* rows_g,
    int n_real, int ld, int rows_cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tail_launch<bf16, 16>(xp, heads, scale, bias, hid, rows_g, n_real,
                                 hbuf, pbest, pidx, ld, tok, G, d, V,
                                 layernorm, tied, rows_cap, s);
  return tail_launch<float, 8>(xp, heads, scale, bias, hid, rows_g, n_real,
                               hbuf, pbest, pidx, ld, tok, G, d, V, layernorm,
                               tied, rows_cap, s);
}
