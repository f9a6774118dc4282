// Hopper (sm_90a) kernel for the Pallas TPU kernel paged_attention
// (replaces src/repro/kernels/paged_attention.py:82, pallas_call at :117,
// body _kernel at :37): one-token GQA decode attention through a block
// table into a page arena [n_pages, page_len, n_kv, hd].
//
// What it computes, as the TPU kernel does: pages with j * page_len > pos
// are skipped; an online softmax keeps m / l / acc in f32 with rounding
// barriers through the query dtype at the score, the probability, the
// correction and the accumulator (paged_attention.py:60-75), so the kernel
// tracks the blocked plain version closely; page ids are read from the block
// table in device memory; page 0 is the pool's scratch page and only ever
// read masked.
//
// Bound: the K/V rows up to each sequence's position (bytes); at decode the
// grid is small (sequences x KV heads) and each block streams a few KB, so a
// call is latency bound. Design: the TPU's sequential page axis becomes a
// loop inside one block per (sequence, KV head); the block stages a page of
// K and V in shared memory once and shares it across its g = nq / n_kv query
// heads (GQA), one thread per head-dim lane. Splitting one long sequence
// across blocks (split-K) is left for later.
#include <cmath>

#include "common.cuh"

using rt::bf16;
using rt::from_f;
using rt::round_t;
using rt::to_f;

namespace {

constexpr int kMaxG = 16;          // query heads per KV head held in registers
constexpr float kNegInf = -1e30f;  // the reference's masked score

template <typename T>
__global__ void paged_attn(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int* __restrict__ block_table,
                           const int* __restrict__ positions,
                           T* __restrict__ out, int nq, int n_kv, int hd,
                           int plen, int nb, float scale) {
  extern __shared__ float sm[];
  const int g = nq / n_kv;
  float* qs = sm;                   // [g][hd]
  float* ks = qs + g * hd;          // [plen][hd]
  float* vs = ks + plen * hd;       // [plen][hd]
  float* ps = vs + plen * hd;       // [g][plen] scores, then probabilities
  float* ms = ps + g * plen;        // [g] running max
  float* ls = ms + g;               // [g] running denominator
  float* cs = ls + g;               // [g] this page's correction

  const int b = blockIdx.x, kvh = blockIdx.y, c = threadIdx.x;
  const int warp = c >> 5, lane = c & 31, nwarps = blockDim.x >> 5;
  const int pos = positions[b];
  const size_t row_stride = (size_t)n_kv * hd;

  for (int h = 0; h < g; ++h)
    qs[h * hd + c] = to_f(q[((size_t)b * nq + kvh * g + h) * hd + c]);
  if (c < g) {
    ms[c] = kNegInf;
    ls[c] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int h = 0; h < kMaxG; ++h) acc[h] = 0.f;

  for (int j = 0; j < nb && j * plen <= pos; ++j) {
    const int page = block_table[(size_t)b * nb + j];
    const T* kpage = kp + (size_t)page * plen * row_stride + kvh * hd;
    const T* vpage = vp + (size_t)page * plen * row_stride + kvh * hd;
#pragma unroll 8
    for (int t = 0; t < plen; ++t) {
      ks[t * hd + c] = to_f(kpage[t * row_stride + c]);
      vs[t * hd + c] = to_f(vpage[t * row_stride + c]);
    }
    __syncthreads();
    // scores: one warp per (head, row) pair, lanes over the head dim
    for (int pr = warp; pr < g * plen; pr += nwarps) {
      const int h = pr / plen, t = pr - h * plen;
      float s = 0.f;
      for (int i = lane; i < hd; i += 32) s += qs[h * hd + i] * ks[t * hd + i];
      s = rt::warp_sum(s);
      if (lane == 0) {
        s = round_t<T>(s * scale);
        ps[h * plen + t] = (j * plen + t <= pos) ? s : kNegInf;
      }
    }
    __syncthreads();
    // online-softmax statistics, one thread per query head
    if (c < g) {
      const int h = c;
      const float m_old = ms[h];
      float mx = ps[h * plen];
      for (int t = 1; t < plen; ++t) mx = fmaxf(mx, ps[h * plen + t]);
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int t = 0; t < plen; ++t) {
        const float p = round_t<T>(expf(ps[h * plen + t] - m_new));
        ps[h * plen + t] = p;
        psum += p;
      }
      const float corr = round_t<T>(expf(m_old - m_new));
      ls[h] = round_t<T>(ls[h] * corr) + psum;
      ms[h] = m_new;
      cs[h] = corr;
    }
    __syncthreads();
    // context accumulator, one thread per head-dim lane (the loop runs to
    // the compile-time kMaxG so acc stays in registers)
#pragma unroll
    for (int h = 0; h < kMaxG; ++h) {
      if (h >= g) break;
      float pv = 0.f;
      for (int t = 0; t < plen; ++t) pv += ps[h * plen + t] * vs[t * hd + c];
      acc[h] = round_t<T>(acc[h] * cs[h]) + round_t<T>(pv);
    }
    __syncthreads();  // the next page overwrites ks / vs / ps
  }
#pragma unroll
  for (int h = 0; h < kMaxG; ++h)
    if (h < g)
      out[((size_t)b * nq + kvh * g + h) * hd + c] = from_f<T>(acc[h] / ls[h]);
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* pos, void* out, int B, int nq,
                   int n_kv, int hd, int plen, int nb, float scale,
                   cudaStream_t stream) {
  const int g = nq / n_kv;
  const size_t smem =
      sizeof(float) * (g * hd + 2 * plen * hd + g * plen + 3 * g);
  cudaError_t e = rt::allow_smem(paged_attn<T>, smem);
  if (e != cudaSuccess) return e;
  paged_attn<T><<<dim3(B, n_kv), hd, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, pos, static_cast<T*>(out), nq, n_kv, hd,
      plen, nb, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes); ``scale`` is 1/sqrt(hd) rounded
// to f32 by the caller. Returns cudaGetLastError().
// The caller guarantees hd % 32 == 0, hd <= 1024, nq % n_kv == 0 and
// nq / n_kv <= 16.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const int* block_table,
                                      const int* positions, void* out, int B,
                                      int nq, int n_kv, int hd, int plen,
                                      int nb, float scale, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(q, k_pages, v_pages, block_table, positions, out, B,
                        nq, n_kv, hd, plen, nb, scale, s);
  return launch<float>(q, k_pages, v_pages, block_table, positions, out, B, nq,
                       n_kv, hd, plen, nb, scale, s);
}
