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
//    Bound: streaming the [d, V] head (622 MB in bf16 at qwen2.5-3b) once.
//    One block per row block would stream it through one SM, so the
//    vocabulary is split across blocks: each block takes 512 columns for one
//    row block, keeps the normed rows in shared memory, and writes its
//    (max, lowest index) pair per row; a second small pass reduces the pairs
//    with the same tie-break. Logits stay in registers; bf16 weights are
//    upcast in registers.
//
//    Tied heads (the [V, d] embedding table, 1.31 GB in bf16 at
//    recurrentgemma-2b) are read in place, never transposed: each thread's
//    two vocab columns are two rows of the table, contiguous in d, read one
//    32-byte sector at a time (two 16-byte loads) and walked in the same k
//    order as the [d, V] layout, so both layouts give the same logits.
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

// R consecutive values as floats: the normed rows of one k (shared memory),
// or one 32-byte sector of a tied head's row (device memory)
template <typename T, int R>
__device__ __forceinline__ void load_rows(const T* p, float* out) {
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = to_f(p[r]);
}
template <>
__device__ __forceinline__ void load_rows<bf16, 16>(const bf16* p, float* out) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = q[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      out[i * 8 + 2 * j] = f.x;
      out[i * 8 + 2 * j + 1] = f.y;
    }
  }
}
template <>
__device__ __forceinline__ void load_rows<float, 8>(const float* p, float* out) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// ---------------------------------------------------------------------------
// decode tail: 2) logits of one 256-column vocab tile + per-row argmax
// ---------------------------------------------------------------------------
template <typename T, int R, bool kTied>
__global__ void tail_logits(const T* __restrict__ h, const T* __restrict__ heads,
                            const int* __restrict__ hid_g,
                            float* __restrict__ pbest, int* __restrict__ pidx,
                            int d, int V, int n_vt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hT = reinterpret_cast<T*>(smem_raw);  // [d][R]: row values of one k
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
  const T* w = heads + (size_t)hid_g[g] * d * V;
  float a0[R], a1[R], hv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a0[r] = a1[r] = 0.f;
  if constexpr (kTied) {
    // [V, d]: columns c0 / c1 are rows of the table (a column past V reads
    // row 0 and is never compared), read one 32-byte sector at a time
    // from a 16-byte aligned start (checked by the wrapper)
    constexpr int kN = 32 / sizeof(T);
    const T* r0 = w + (size_t)(ok0 ? c0 : 0) * d;
    const T* r1 = w + (size_t)(ok1 ? c1 : 0) * d;
    for (int k0 = 0; k0 < d; k0 += kN) {
      float w0[kN], w1[kN];
      load_rows<T, kN>(r0 + k0, w0);
      load_rows<T, kN>(r1 + k0, w1);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        load_rows<T, R>(hT + (k0 + j) * R, hv);
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
      const T* wk = w + (size_t)k * V;
      const float w0 = ok0 ? to_f(wk[c0]) : 0.f;
      const float w1 = ok1 ? to_f(wk[c1]) : 0.f;
      load_rows<T, R>(hT + k * R, hv);
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
    pbest[row * n_vt + vt] = bv;
    pidx[row * n_vt + vt] = bi;
  }
}

// decode tail: 3) reduce the per-tile pairs of each row (one warp a row)
__global__ void tail_reduce(const float* __restrict__ pbest,
                            const int* __restrict__ pidx, int* __restrict__ tok,
                            int rows, int n_vt) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int j = lane; j < n_vt; j += 32)
    rt::arg_better(bv, bi, pbest[(size_t)row * n_vt + j],
                   pidx[(size_t)row * n_vt + j]);
  rt::warp_argmax(bv, bi);
  if (lane == 0) tok[row] = bi;
}

template <typename T, int R, bool kTied>
cudaError_t tail_logits_launch(const void* hbuf, const void* heads,
                               const int* hid, float* pbest, int* pidx, int G,
                               int d, int V, int n_vt, cudaStream_t stream) {
  const size_t smem = sizeof(T) * R * d;
  cudaError_t e = rt::allow_smem(tail_logits<T, R, kTied>, smem);
  if (e != cudaSuccess) return e;
  tail_logits<T, R, kTied><<<dim3(n_vt, G), kTT, smem, stream>>>(
      static_cast<const T*>(hbuf), static_cast<const T*>(heads), hid, pbest,
      pidx, d, V, n_vt);
  return cudaSuccess;
}

template <typename T, int R>
cudaError_t tail_launch(const void* xp, const void* heads, const void* scale,
                        const void* bias, const int* hid, void* hbuf,
                        float* pbest, int* pidx, int* tok, int G, int d, int V,
                        int layernorm, int tied, cudaStream_t stream) {
  const int n_vt = (V + kVT - 1) / kVT;
  tail_norm<T><<<G * R, 256, 0, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<T*>(hbuf), d, layernorm);
  cudaError_t e =
      tied ? tail_logits_launch<T, R, true>(hbuf, heads, hid, pbest, pidx, G,
                                            d, V, n_vt, stream)
           : tail_logits_launch<T, R, false>(hbuf, heads, hid, pbest, pidx, G,
                                             d, V, n_vt, stream);
  if (e != cudaSuccess) return e;
  const int rows = G * R;
  tail_reduce<<<(rows + 3) / 4, 128, 0, stream>>>(pbest, pidx, tok, rows,
                                                 n_vt);
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

// ``tied``: heads is [H, V, d] (the embedding table) instead of [H, d, V];
// the caller guarantees d is a multiple of one 32-byte sector and 16-byte
// aligned rows.
extern "C" int decode_tail_grouped_launch(
    const void* xp, const void* heads, const void* scale, const void* bias,
    const int* hid, void* hbuf, float* pbest, int* pidx, int* tok, int G,
    int d, int V, int layernorm, int tied, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tail_launch<bf16, 16>(xp, heads, scale, bias, hid, hbuf, pbest,
                                 pidx, tok, G, d, V, layernorm, tied, s);
  return tail_launch<float, 8>(xp, heads, scale, bias, hid, hbuf, pbest, pidx,
                               tok, G, d, V, layernorm, tied, s);
}
