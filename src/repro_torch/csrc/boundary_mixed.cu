// Hopper (sm_90a) kernels for the two Pallas TPU kernels of
// src/repro/kernels/boundary_mixed.py:
//
//  * boundary_mixed_grouped (replaces boundary_mixed.py:196, pallas_call at
//    :237, body _kernel at :37): the mixed-mode bottleneck boundary. Per
//    mode-uniform block of R rows: rmsnorm (f32) x head scale -> model dtype;
//    down-projection over ceil(width/128) chunks, each chunk's f32 sum rounded
//    to the model dtype with lanes >= width zeroed; row-wise symmetric
//    quant -> dequant (rintf, half to even like jnp.round; skipped at bits 0);
//    up-projection with f32 accumulation -> model dtype. Blocks with zero
//    chunks (mode 0 and padding) copy their rows through bit for bit.
//
//    Bound: at decode (a few rows) the bank's weights dominate the bytes
//    (d x wmax down + wmax x d up, 4 MB in bf16 at qwen2.5-3b), so the kernel
//    is memory bound. The TPU walks the width chunks as a sequential grid axis
//    with a VMEM accumulator; one block per row block would leave all but one
//    or two of the 132 SMs idle. So the work is split into four launches:
//    row norms; the down-projection split over (row block, width chunk,
//    K slice) blocks writing f32 partial sums; a pass with one block per row
//    that sums the K slices in a fixed order, rounds, masks and quantizes;
//    and the up-projection split over (row block, 128-column tile) blocks.
//    Every weight byte is read by exactly one block. At a few rows each
//    launch is latency bound, so the weight loops are unrolled deep enough
//    to keep several independent loads in flight per thread.
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
//    decode tick. Three launches: the row norms (a block per row); the
//    logits and a (max, lowest index) pair per row and block; a pass that
//    reduces the pairs with the same tie-break.
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
using rt::from_f;
using rt::round_t;
using rt::to_f;

namespace {

constexpr int kBW = 128;       // width-chunk lanes (the TPU's block_w)
constexpr int kThreads = 128;  // threads of the boundary kernels
constexpr int kTT = 256;       // threads of the tail's logit kernel
constexpr int kVT = 2 * kTT;   // vocab columns per tail block (two a thread)

// ---------------------------------------------------------------------------
// boundary: 1) inverse rms of every row of a quantized block (block per row)
// ---------------------------------------------------------------------------
template <typename T, int R>
__global__ void bm_rownorm(const T* __restrict__ xp, const int* __restrict__ nchunk,
                           float* __restrict__ inv, int d) {
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x, row = g * R + blockIdx.y;
  if (nchunk[g] == 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* x = xp + (size_t)row * d;
  float ss = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x; k < d; k += kThreads) {
    const float v = to_f(x[k]);
    ss += v * v;
  }
  ss = rt::warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    inv[row] = rsqrtf(t / (float)d + 1e-6f);
  }
}

// ---------------------------------------------------------------------------
// boundary: 2) down-projection partial sums over one K slice of one chunk
// ---------------------------------------------------------------------------
template <typename T, int R>
__global__ void bm_down(const T* __restrict__ xp, const T* __restrict__ down_w,
                        const T* __restrict__ norm_scale,
                        const int* __restrict__ hid_g,
                        const int* __restrict__ nchunk,
                        const float* __restrict__ inv,
                        float* __restrict__ partial, int P, int d, int wmax,
                        int kc) {
  extern __shared__ float hs[];  // [R][kc] normed rows of this K slice
  const int g = blockIdx.x, c = blockIdx.y, ks = blockIdx.z;
  if (c >= nchunk[g]) return;  // chunks past the head's width: skipped
  const int hid = hid_g[g];
  const int k0 = ks * kc;
  const int kn = max(min(kc, d - k0), 0);
#pragma unroll 8
  for (int i = threadIdx.x; i < R * kn; i += blockDim.x) {
    const int r = i / kn, kk = i - r * kn, row = g * R + r;
    // (x * rsqrt(mean(x^2) + eps)) * scale, rounded to the model dtype
    hs[r * kc + kk] = round_t<T>(to_f(xp[(size_t)row * d + k0 + kk]) *
                                 inv[row] *
                                 to_f(norm_scale[(size_t)hid * d + k0 + kk]));
  }
  __syncthreads();
  const int col = c * kBW + threadIdx.x;
  if (col >= wmax) return;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const T* w = down_w + ((size_t)hid * d + k0) * wmax + col;
#pragma unroll 8
  for (int kk = 0; kk < kn; ++kk) {
    const float wv = to_f(w[(size_t)kk * wmax]);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += hs[r * kc + kk] * wv;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    partial[((size_t)ks * P + g * R + r) * wmax + col] = acc[r];
}

// ---------------------------------------------------------------------------
// boundary: 3) sum the K slices, round, mask, quantize -> dequantized code
//    (one block per row, so the rows of a block quantize in parallel)
// ---------------------------------------------------------------------------
template <typename T, int R>
__global__ void bm_quant(const float* __restrict__ partial,
                         const int* __restrict__ nchunk,
                         const int* __restrict__ width_g,
                         const int* __restrict__ bits_g, T* __restrict__ wired,
                         int P, int wmax, int n_ks) {
  extern __shared__ float zs[];  // [wmax] the row's code z
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x;
  if (nchunk[g] == 0) return;
  const int width = width_g[g], bits = bits_g[g];
  const float qm = (float)max((1 << (max(bits, 1) - 1)) - 1, 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = g * R + blockIdx.y;
  float mx = 0.f;
  for (int col = threadIdx.x; col < wmax; col += blockDim.x) {
    float z = 0.f;
    if (col < width) {
      float s = 0.f;
#pragma unroll 4
      for (int ks = 0; ks < n_ks; ++ks)  // fixed order: reproducible
        s += partial[((size_t)ks * P + row) * wmax + col];
      z = round_t<T>(s);  // the per-chunk model-dtype barrier
    }
    zs[col] = z;
    mx = fmaxf(mx, fabsf(z));
  }
  mx = rt::warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float absmax = red[0];
  for (int w = 1; w < kThreads / 32; ++w) absmax = fmaxf(absmax, red[w]);
  const float scale = fmaxf(absmax, 1e-8f) / qm;
  for (int col = threadIdx.x; col < wmax; col += blockDim.x) {
    const float z = zs[col];
    float v = z;
    if (bits != 0) {
      const float code = fminf(fmaxf(rintf(z / scale), -qm), qm);
      v = code * scale;
    }
    wired[(size_t)row * wmax + col] = from_f<T>(v);
  }
}

// ---------------------------------------------------------------------------
// boundary: 4) up-projection of one 128-column tile (or raw passthrough)
// ---------------------------------------------------------------------------
template <typename T, int R>
__global__ void bm_up(const T* __restrict__ xp, const T* __restrict__ up_w,
                      const int* __restrict__ hid_g,
                      const int* __restrict__ nchunk,
                      const int* __restrict__ width_g,
                      const T* __restrict__ wired, T* __restrict__ out, int d,
                      int wmax) {
  extern __shared__ float ws[];  // [R][width] dequantized codes
  const int g = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  if (nchunk[g] == 0) {  // mode 0: the raw code z crosses unchanged
    if (col < d)
      for (int r = 0; r < R; ++r) {
        const size_t i = (size_t)(g * R + r) * d + col;
        out[i] = xp[i];
      }
    return;
  }
  const int hid = hid_g[g], width = width_g[g];
#pragma unroll 8
  for (int i = threadIdx.x; i < R * width; i += blockDim.x) {
    const int r = i / width, w = i - r * width;
    ws[r * width + w] = to_f(wired[(size_t)(g * R + r) * wmax + w]);
  }
  __syncthreads();
  if (col >= d) return;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  // lanes >= width carry exact zeros: skipping them leaves the sum unchanged
  const T* u = up_w + (size_t)hid * wmax * d + col;
#pragma unroll 16
  for (int w = 0; w < width; ++w) {
    const float uv = to_f(u[(size_t)w * d]);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += ws[r * width + w] * uv;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    out[(size_t)(g * R + r) * d + col] = from_f<T>(acc[r]);
}

template <typename T, int R>
cudaError_t boundary_launch(const void* xp, const void* down_w, const void* up_w,
                            const void* norm_scale, const int* hid,
                            const int* nch, const int* width, const int* bits,
                            void* out, float* inv, float* partial, void* wired,
                            int P, int d, int wmax, int n_ks,
                            cudaStream_t stream) {
  const int G = P / R;
  const int n_w = (wmax + kBW - 1) / kBW;
  const int kc = (d + n_ks - 1) / n_ks;
  const T* x = static_cast<const T*>(xp);
  bm_rownorm<T, R><<<dim3(G, R), kThreads, 0, stream>>>(x, nch, inv, d);

  const size_t smem_down = sizeof(float) * R * kc;
  cudaError_t e = rt::allow_smem(bm_down<T, R>, smem_down);
  if (e != cudaSuccess) return e;
  bm_down<T, R><<<dim3(G, n_w, n_ks), kThreads, smem_down, stream>>>(
      x, static_cast<const T*>(down_w), static_cast<const T*>(norm_scale), hid,
      nch, inv, partial, P, d, wmax, kc);

  const size_t smem_q = sizeof(float) * wmax;
  if ((e = rt::allow_smem(bm_quant<T, R>, smem_q)) != cudaSuccess) return e;
  bm_quant<T, R><<<dim3(G, R), kThreads, smem_q, stream>>>(
      partial, nch, width, bits, static_cast<T*>(wired), P, wmax, n_ks);

  const size_t smem_up = sizeof(float) * R * wmax;
  if ((e = rt::allow_smem(bm_up<T, R>, smem_up)) != cudaSuccess) return e;
  bm_up<T, R><<<dim3(G, (d + kThreads - 1) / kThreads), kThreads, smem_up,
                 stream>>>(x, static_cast<const T*>(up_w), hid, nch, width,
                           static_cast<const T*>(wired), static_cast<T*>(out),
                           d, wmax);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode tail: 1) final norm of one row (a block per row), rounded through
//    the model dtype
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
    const float y = (to_f(x[k]) - mu) * iv * to_f(scale[k]) + to_f(bias[k]);
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
                            int d, int V, int ld) {
  constexpr int R = 8;  // rows of an f32 row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hT = reinterpret_cast<float*>(smem_raw);  // [d][R]: rows at one k
  __shared__ float rb[R][kTT / 32];
  __shared__ int ri[R][kTT / 32];
  const int vt = blockIdx.x, g = blockIdx.y;
#pragma unroll 8
  for (int i = threadIdx.x; i < R * d; i += blockDim.x) {
    const int r = i / d, k = i - r * d;
    hT[k * R + r] = h[((size_t)g * R + r) * d + k];
  }
  __syncthreads();
  const int c0 = vt * kVT + threadIdx.x, c1 = c0 + kTT;
  const bool ok0 = c0 < V, ok1 = c1 < V;
  const float* w = heads + (size_t)hid_g[g] * d * V;
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

// 16-byte cp.async that writes zeros when ``ok`` is false (nothing read)
__device__ __forceinline__ void cp_async16_or_zero(void* smem, const void* g,
                                                   bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(g), "r"(ok ? 16 : 0));
}

template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kTied>
__host__ __device__ constexpr int stage_elems() {  // one staged tile, padded rows
  return kTied ? kMV * (kKC + kPad) : kKC * (kMV + kPad);
}

template <bool kTied>
size_t tail_mma_smem(int d) {
  return sizeof(bf16) * ((size_t)kRB * (d + kPad) +
                         (size_t)kStages * stage_elems<kTied>());
}

// Block (x, g): the contiguous run of vocab slabs x of row block g. A slab's
// logits: acc[mt][nt] is the m16n8 tile of this warp's vocab columns
// warp*32 + mt*16 and rows nt*8; thread t holds vocab (t/4, +8) x rows
// (t%4)*2 + {0, 1}. Rows past the block's real rows are zero and never
// compared; a block with none writes (-inf, 0) pairs.
template <bool kTied>
__global__ void __launch_bounds__(kMT)
    tail_mma(const bf16* __restrict__ h, const bf16* __restrict__ heads,
             const int* __restrict__ hid_g, const int* __restrict__ rows_g,
             int n_real, float* __restrict__ pbest, int* __restrict__ pidx,
             int ld, int d, int V, int n_slabs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float rb[kMT / 32][kRB];
  __shared__ int ri[kMT / 32][kRB];
  const int g = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int nrows = rows_g != nullptr ? rows_g[g]
                                      : min(max(n_real - g * kRB, 0), kRB);
  if (nrows == 0) {
    if (tid < kRB) {
      pbest[(size_t)(g * kRB + tid) * ld + blockIdx.x] = -INFINITY;
      pidx[(size_t)(g * kRB + tid) * ld + blockIdx.x] = 0;
    }
    return;
  }
  const int ntiles = (nrows + 7) >> 3;
  const int per = n_slabs / gridDim.x, extra = n_slabs % gridDim.x;
  const int s0 = blockIdx.x * per + min((int)blockIdx.x, extra);
  const int ns = per + ((int)blockIdx.x < extra ? 1 : 0);
  const int hs = d + kPad;
  bf16* hsm = reinterpret_cast<bf16*>(smem_raw);  // [16][d + pad]
  bf16* ring = hsm + kRB * hs;
  constexpr int kSE = stage_elems<kTied>();
  const bf16* w = heads + (size_t)hid_g[g] * d * V;

  // the block's normed rows; rows >= nrows are zeros
  const int c8 = d / 8;
  for (int i = tid; i < kRB * c8; i += kMT) {
    const int r = i / c8, c = i - r * c8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nrows)
      v = *reinterpret_cast<const uint4*>(h + ((size_t)g * kRB + r) * d + c * 8);
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
  const bf16* b_base = hsm + ((q >> 1) * 8 + rr) * hs + (q & 1) * 8;
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
  if (tid < kRB) {
    float bv = -INFINITY;
    int bi = 0;
    if (tid < nrows) {
      bv = rb[0][tid];
      bi = ri[0][tid];
      for (int wi = 1; wi < kMT / 32; ++wi)
        rt::arg_better(bv, bi, rb[wi][tid], ri[wi][tid]);
    }
    pbest[(size_t)(g * kRB + tid) * ld + blockIdx.x] = bv;
    pidx[(size_t)(g * kRB + tid) * ld + blockIdx.x] = bi;
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

template <bool kTied>
cudaError_t tail_mma_launch(const void* hbuf, const void* heads, const int* hid,
                            const int* rows_g, int n_real, float* pbest,
                            int* pidx, int ld, int G, int d, int V, int n_sms,
                            int* n_part, cudaStream_t stream) {
  const int n_slabs = (V + kMV - 1) / kMV;
  const int gx = std::max(1, std::min(n_slabs, std::min(ld, n_sms / G)));
  const size_t smem = tail_mma_smem<kTied>(d);
  cudaError_t e = rt::allow_smem(tail_mma<kTied>, smem);
  if (e != cudaSuccess) return e;
  tail_mma<kTied><<<dim3(gx, G), kMT, smem, stream>>>(
      static_cast<const bf16*>(hbuf), static_cast<const bf16*>(heads), hid,
      rows_g, n_real, pbest, pidx, ld, d, V, n_slabs);
  *n_part = gx;
  return cudaSuccess;
}

template <bool kTied>
cudaError_t tail_logits_launch(const void* hbuf, const void* heads,
                               const int* hid, float* pbest, int* pidx, int G,
                               int d, int V, int n_vt, int ld,
                               cudaStream_t stream) {
  const size_t smem = sizeof(float) * 8 * d;
  cudaError_t e = rt::allow_smem(tail_logits<kTied>, smem);
  if (e != cudaSuccess) return e;
  tail_logits<kTied><<<dim3(n_vt, G), kTT, smem, stream>>>(
      static_cast<const float*>(hbuf), static_cast<const float*>(heads), hid,
      pbest, pidx, d, V, ld);
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
                        int tied, cudaStream_t stream) {
  tail_norm<T><<<G * R, 256, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(hbuf), d, layernorm);
  int n_part = 0;
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    e = tied ? tail_mma_launch<true>(hbuf, heads, hid, rows_g, n_real, pbest,
                                     pidx, ld, G, d, V, sm_count(), &n_part,
                                     stream)
             : tail_mma_launch<false>(hbuf, heads, hid, rows_g, n_real, pbest,
                                      pidx, ld, G, d, V, sm_count(), &n_part,
                                      stream);
  } else {
    n_part = (V + kVT - 1) / kVT;
    if (n_part > ld) return cudaErrorInvalidValue;
    e = tied ? tail_logits_launch<true>(hbuf, heads, hid, pbest, pidx, G, d, V,
                                        n_part, ld, stream)
             : tail_logits_launch<false>(hbuf, heads, hid, pbest, pidx, G, d,
                                         V, n_part, ld, stream);
  }
  if (e != cudaSuccess) return e;
  const int rows = G * R;
  tail_reduce<<<(rows + 3) / 4, 128, 0, stream>>>(pbest, pidx, tok, rows,
                                                 n_part, ld);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). Pointers are device pointers;
// the scratch buffers come from the caller. Returns cudaGetLastError().
extern "C" int boundary_mixed_grouped_launch(
    const void* xp, const void* down_w, const void* up_w,
    const void* norm_scale, const int* hid, const int* nchunk,
    const int* width, const int* bits, void* out, float* inv, float* partial,
    void* wired, int P, int d, int wmax, int n_ks, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return boundary_launch<bf16, 16>(xp, down_w, up_w, norm_scale, hid, nchunk,
                                     width, bits, out, inv, partial, wired, P,
                                     d, wmax, n_ks, s);
  return boundary_launch<float, 8>(xp, down_w, up_w, norm_scale, hid, nchunk,
                                   width, bits, out, inv, partial, wired, P, d,
                                   wmax, n_ks, s);
}

// ``tied``: heads is [H, V, d] (the embedding table) instead of [H, d, V].
// ``pbest`` / ``pidx``: [G * R, ld] scratch, ld >= ceil(V / 128). Real rows
// of row block g: ``rows_g[g]`` when given, else min(n_real - g * R, R)
// (only the bf16 path reads them; the f32 path computes every row). The
// caller guarantees, in bf16, d % 64 == 0, V % 8 == 0 and 16-byte aligned
// heads; in f32, d a multiple of 8 and 16-byte aligned rows.
extern "C" int decode_tail_grouped_launch(
    const void* xp, const void* heads, const void* scale, const void* bias,
    const int* hid, void* hbuf, float* pbest, int* pidx, int* tok, int G,
    int d, int V, int layernorm, int tied, int is_bf16, const int* rows_g,
    int n_real, int ld, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tail_launch<bf16, 16>(xp, heads, scale, bias, hid, rows_g, n_real,
                                 hbuf, pbest, pidx, ld, tok, G, d, V,
                                 layernorm, tied, s);
  return tail_launch<float, 8>(xp, heads, scale, bias, hid, rows_g, n_real,
                               hbuf, pbest, pidx, ld, tok, G, d, V, layernorm,
                               tied, s);
}
