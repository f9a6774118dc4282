// Hopper (sm_90a) kernels for the Pallas TPU kernel paged_attention
// (replaces src/repro/kernels/paged_attention.py:82, pallas_call at :117,
// body _kernel at :37): one-token GQA decode attention through a block
// table into a page arena [n_pages, page_len, n_kv, hd].
//
// What it computes, as the TPU kernel does: pages with j * page_len > pos
// are skipped; an online softmax keeps m / l / acc in f32 with rounding
// barriers through the query dtype at the score, the probability, the
// correction and the l / acc hand-offs (paged_attention.py:60-75). Page 0
// is the pool's scratch page and only ever read masked.
//
// Bound: the K/V rows up to each sequence's position (bytes). The TPU walks
// the pages as a sequential grid axis; on the card that leaves one block
// per (sequence, KV head) walking every page of a long sequence alone. The
// recurrence does not force that. With m_j the running max after page j,
// m_j = max(m_{j-1}, max s_j) is a prefix max of per-page maxima, and given
// the m_j every page's p_j = round(exp(s_j - m_j)), corr_j =
// round(exp(m_{j-1} - m_j)), psum_j = sum p_j and pv_j = round(p_j . v_j)
// are independent of the other pages. Only l = round(l * corr_j) + psum_j
// and acc = round(acc * corr_j) + pv_j stay serial: two element-wise
// operations a page. Every value is the one the sequential order gives, so
// the kernels keep the reference's numbers (ref.paged_attention_split_ref
// mirrors this order on the CPU).
//
// Two forms, chosen by pages_per_split (the dispatcher's pick):
//  * one range (pages_per_split >= nb): one launch, one block per
//    (sequence, KV head) doing all of the above over its pages in chunks of
//    up to 128 rows. Each chunk's K and V arrive by 16-byte cp.async; with
//    more than one chunk, into a ring of two stages, the next chunk's
//    copies in flight while this one computes. The decode shape of the main
//    path (a few pages) is one chunk.
//  * split (pages_per_split < nb): the pages of a sequence are cut into
//    ranges, one block per (sequence, KV head, range), in three launches:
//    A) scores and page maxima of the range, K streamed once, into scratch;
//    B) the prefix max from the earlier pages' maxima, then p, corr, psum
//       and pv of the range, V streamed once, into scratch;
//    C) the serial l / acc combine over pages, one thread per (head, lane),
//       and the division.
// Within a block (hd threads per head slice, rounded up to whole warps: the
// lanes past the slices idle in pv and the stores, so every warp loop and
// full-mask shuffle runs on whole warps at any hd % 16 == 0, e.g. 80): the
// g = nq / n_kv query heads of one KV head share each staged K/V row
// (GQA). The block reads its position and its block-table row in
// parallel, so a decode waits on two dependent trips to memory (table,
// then K/V), not three. Scores: one lane
// per row, a warp per 32 rows and two heads, q read from shared memory as a
// broadcast, K rows padded by 16 bytes so the 16-byte row reads of a warp
// do not collide. Page statistics: a warp per head, a lane per page, the
// prefix max by a warp scan; p is stored row-major over heads, so pv reads
// one V element and the g probabilities of a row as float4 broadcasts and
// runs one FMA chain per head of its slice (hd threads a slice of 4, 8 or
// 16 heads, a template argument: no branch in the row loop). The combine's
// loads are double-buffered into shared memory ahead of its serial chain
// (a thread per head-dim lane, rounded up to whole warps).
//
// Every sum runs in index order (q . k over the head dim, p over a page's
// rows, p . v over them), the order ref.paged_attention_ref fixes. With
// bf16 inputs the products are exact in f32, so the kernels and the plain
// version agree bit for bit; in f32 the FMAs round once where the plain
// version rounds twice.
#include <algorithm>
#include <cmath>
#include <type_traits>

#include "common.cuh"

using rt::bf16;
using rt::from_f;
using rt::round_t;
using rt::to_f;

namespace {

constexpr int kHG = 2;             // query heads per score work item
constexpr int kMaxChunk = 32;      // pages per staged chunk (a lane a page)
constexpr int kChunkRows = 128;    // rows per staged chunk, at most
constexpr size_t kSmemCap = 200 * 1024;
constexpr float kNegInf = -1e30f;  // the reference's masked score

struct Geo {  // shapes of one call
  int nq, n_kv, g, hd, plen, nb;
  int ch, ns;  // pages per staged chunk, ring stages (1 or 2)
  int gp, ps;  // heads a p row holds (slices * PER); floats a page of p
  float scale;
};

__host__ __device__ inline size_t al16(size_t b) { return (b + 15) & ~size_t(15); }

// threads of a block: n, rounded up to whole warps
__host__ __device__ inline int whole_warps(int n) { return (n + 31) & ~31; }

struct Carve {  // bump allocator over dynamic shared memory
  unsigned char* p;
  template <typename U> __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += al16(n * sizeof(U));
    return r;
  }
};

__device__ __forceinline__ int live_pages(int pos, const Geo& G) {
  return pos < 0 ? 0 : min(G.nb, pos / G.plen + 1);
}

// cp.async the rows of np pages (ids in pid) of one KV head into dst
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dstride, const T* src, const int* pid,
                           int np, const Geo& G, int kvh) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = G.hd / V;
  const int n = np * G.plen * cpr;
  const size_t rs = (size_t)G.n_kv * G.hd;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / cpr, c = i - r * cpr;
    const int jj = r / G.plen, t = r - jj * G.plen;
    rt::cp_async16(dst + r * dstride + c * V,
                   src + ((size_t)pid[jj] * G.plen + t) * rs +
                       (size_t)kvh * G.hd + c * V);
  }
}

// masked, rounded scores of nr staged rows (absolute rows row0 + r) for
// every head: ss[h][r]
template <typename T>
__device__ __forceinline__ void chunk_scores(const T* ks, int kstride, const float* qs,
                             float* ss, int CR, int nr, int row0, int pos,
                             const Geo& G) {
  constexpr int V = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int ngr = (G.g + kHG - 1) / kHG;
  const int items = ((nr + 31) >> 5) * ngr;
  for (int it = warp; it < items; it += nw) {
    const int r = (it / ngr) * 32 + lane, h0 = (it % ngr) * kHG;
    if (r >= nr) continue;
    float a[kHG];
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) a[hh] = 0.f;
    const T* kr = ks + r * kstride;
#pragma unroll 4
    for (int i = 0; i < G.hd; i += V) {
      float kf[V];
      rt::smem16_to_f(kr + i, kf);
#pragma unroll
      for (int hh = 0; hh < kHG; ++hh) {
        const int h = min(h0 + hh, G.g - 1);  // a short last group repeats
        const float4* q4 = reinterpret_cast<const float4*>(qs + h * G.hd + i);
#pragma unroll
        for (int e4 = 0; e4 < V / 4; ++e4) {
          const float4 qv = q4[e4];
          a[hh] = fmaf(qv.x, kf[4 * e4], a[hh]);
          a[hh] = fmaf(qv.y, kf[4 * e4 + 1], a[hh]);
          a[hh] = fmaf(qv.z, kf[4 * e4 + 2], a[hh]);
          a[hh] = fmaf(qv.w, kf[4 * e4 + 3], a[hh]);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh)
      if (h0 + hh < G.g) {
        const float s = round_t<T>(a[hh] * G.scale);
        ss[(h0 + hh) * CR + r] = (row0 + r <= pos) ? s : kNegInf;
      }
  }
}

// Page statistics of np staged pages, a warp per head and a lane per page:
// m_j from the running max ms[h] and a warp max scan; p into pt (page jj,
// row t, head h at jj * ps + t * gp + h), corr_j into cs[h][jj], psum_j;
// with cg / psg corr and psum also go to global scratch at page jg0 + jj;
// with ls the l recurrence runs here.
template <typename T>
__device__ __forceinline__ void page_stats(const float* ss, int CR, int np, const Geo& G,
                           float* pt, float* ms, float* ls, float* cs,
                           float* cg, float* psg, size_t gbase, int jg0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const bool live = lane < np;
  for (int h = warp; h < G.g; h += nw) {
    const float* sh = ss + h * CR + lane * G.plen;
    float pm = kNegInf;
    if (live) {
#pragma unroll 8
      for (int t = 0; t < G.plen; ++t) pm = fmaxf(pm, sh[t]);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive max scan over pages
      const float v = __shfl_up_sync(0xffffffffu, pm, o);
      if (lane >= o) pm = fmaxf(pm, v);
    }
    const float m_run = ms[h];
    const float mj = fmaxf(m_run, pm);
    const float up = __shfl_up_sync(0xffffffffu, mj, 1);
    const float mb = lane == 0 ? m_run : up;  // m_{j-1}
    float corr = 0.f, psum = 0.f;
    if (live) {
      corr = round_t<T>(expf(mb - mj));
      float* pl = pt + lane * G.ps + h;
#pragma unroll 8
      for (int t = 0; t < G.plen; ++t) {
        const float p = round_t<T>(expf(sh[t] - mj));
        pl[t * G.gp] = p;
        psum += p;
      }
      cs[h * kMaxChunk + lane] = corr;
      if (cg != nullptr) {
        cg[(gbase + h) * G.nb + jg0 + lane] = corr;
        psg[(gbase + h) * G.nb + jg0 + lane] = psum;
      }
    }
    if (ls != nullptr) {
      float l = ls[h];
#pragma unroll 4
      for (int k = 0; k < np; ++k) {
        const float c = __shfl_sync(0xffffffffu, corr, k);
        const float s = __shfl_sync(0xffffffffu, psum, k);
        l = __fadd_rn(round_t<T>(__fmul_rn(l, c)), s);
      }
      if (lane == 0) ls[h] = l;
    }
    const float m_last = __shfl_sync(0xffffffffu, mj, np - 1);
    __syncwarp();
    if (lane == 0) ms[h] = m_last;
  }
}

// pv of np staged pages for this thread's lane c = t % hd and its PER heads
// from h0 = (t / hd) * PER (threads t < hd * gp / PER, the slices; the
// block's last warp may hold idle threads past them): each row's V element
// once, its probabilities as float4 broadcasts, PER independent FMA chains
// over the page's rows in order, no branch inside the row loop; each
// page's pv folded into acc (one range) or written rounded to global
// scratch (split). Heads past g compute on padding and are dropped.
template <typename T, int PER, bool kStore>
__device__ __forceinline__ void chunk_pv(const T* vs, const float* pt,
                                         const float* cs, int np, const Geo& G,
                                         float* acc, T* pvg, size_t bk,
                                         int jg0) {
  if ((int)threadIdx.x >= G.hd * (G.gp / PER)) return;  // idle lanes
  const int c = threadIdx.x % G.hd, h0 = (threadIdx.x / G.hd) * PER;
  for (int jj = 0; jj < np; ++jj) {
    float pv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) pv[k] = 0.f;
    const float* pp = pt + jj * G.ps + h0;
    const T* v = vs + jj * G.plen * G.hd + c;
#pragma unroll 8
    for (int t = 0; t < G.plen; ++t) {
      const float vt = to_f(v[t * G.hd]);
      const float4* p4 = reinterpret_cast<const float4*>(pp + t * G.gp);
#pragma unroll
      for (int k4 = 0; k4 < PER / 4; ++k4) {
        const float4 p = p4[k4];
        pv[4 * k4] = fmaf(p.x, vt, pv[4 * k4]);
        pv[4 * k4 + 1] = fmaf(p.y, vt, pv[4 * k4 + 1]);
        pv[4 * k4 + 2] = fmaf(p.z, vt, pv[4 * k4 + 2]);
        pv[4 * k4 + 3] = fmaf(p.w, vt, pv[4 * k4 + 3]);
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int h = h0 + k;
      if (h >= G.g) continue;
      if constexpr (kStore) {
        pvg[((bk * G.nb + jg0 + jj) * G.g + h) * G.hd + c] = from_f<T>(pv[k]);
      } else {
        acc[k] = __fadd_rn(
            round_t<T>(__fmul_rn(acc[k], cs[h * kMaxChunk + jj])),
            round_t<T>(pv[k]));
      }
    }
  }
}

// the block's g query rows as f32, 16 bytes a load (q rows are hd * 2 or
// hd * 4 bytes, 16-byte aligned)
template <typename T>
__device__ __forceinline__ void load_q(const T* q, float* qs, int b, int kvh, const Geo& G) {
  constexpr int V = 16 / sizeof(T);
  const T* qb = q + ((size_t)b * G.nq + (size_t)kvh * G.g) * G.hd;
  for (int i = threadIdx.x * V; i < G.g * G.hd; i += blockDim.x * V) {
    const uint4 u = *reinterpret_cast<const uint4*>(qb + i);
    float f[V];
    rt::smem16_to_f(reinterpret_cast<const T*>(&u), f);
#pragma unroll
    for (int e = 0; e < V; ++e) qs[i + e] = f[e];
  }
}

// the block-table entries [j0, j1) of sequence b (valid page ids whether
// live or not, so they load beside the position, not after it)
__device__ __forceinline__ void load_pid(int* pid, const int* bt, int b, int j0,
                                         int j1, const Geo& G) {
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x)
    pid[j - j0] = bt[(size_t)b * G.nb + j];
}

// ---------------------------------------------------------------------------
// one range: a block per (sequence, KV head) over all of its pages
// ---------------------------------------------------------------------------
template <typename T>
size_t fused_smem(const Geo& G) {
  const size_t CR = (size_t)G.ch * G.plen, es = sizeof(T);
  return al16(G.nb * 4) + al16(G.g * G.hd * 4) + al16(G.g * CR * 4) +
         al16(G.ch * G.ps * 4) + al16(G.g * kMaxChunk * 4) +
         2 * al16(G.g * 4) + al16(G.ns * CR * (G.hd + 16 / es) * es) +
         al16(G.ns * CR * G.hd * es);
}

template <typename T, int PER>
__global__ void __launch_bounds__(256)
    paged_fused(const T* __restrict__ q, const T* __restrict__ kp,
                const T* __restrict__ vp, const int* __restrict__ bt,
                const int* __restrict__ positions, T* __restrict__ out,
                Geo G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int CR = G.ch * G.plen, kstride = G.hd + 16 / (int)sizeof(T);
  Carve cv{smem};
  int* pid = cv.take<int>(G.nb);
  float* qs = cv.take<float>(G.g * G.hd);
  float* ss = cv.take<float>(G.g * CR);
  float* pt = cv.take<float>(G.ch * G.ps);
  float* cs = cv.take<float>(G.g * kMaxChunk);
  float* ms = cv.take<float>(G.g);
  float* ls = cv.take<float>(G.g);
  T* kst = cv.take<T>(G.ns * CR * kstride);
  T* vst = cv.take<T>(G.ns * CR * G.hd);

  const int pos = positions[b];
  load_pid(pid, bt, b, 0, G.nb, G);
  load_q(q, qs, b, kvh, G);
  if (threadIdx.x < G.g) {
    ms[threadIdx.x] = kNegInf;
    ls[threadIdx.x] = 0.f;
  }
  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.f;
  const int n_live = live_pages(pos, G);
  __syncthreads();

  const int nch = (n_live + G.ch - 1) / G.ch;
  auto fetch = [&](int ci) {
    const int j0 = ci * G.ch, np = min(G.ch, n_live - j0), st = ci & 1;
    stage_rows(kst + st * CR * kstride, kstride, kp, pid + j0, np, G, kvh);
    stage_rows(vst + st * CR * G.hd, G.hd, vp, pid + j0, np, G, kvh);
    rt::cp_async_commit();
  };
  if (nch > 0) fetch(0);
  for (int ci = 0; ci < nch; ++ci) {
    const int j0 = ci * G.ch, np = min(G.ch, n_live - j0), st = ci & 1;
    if (ci + 1 < nch) {
      fetch(ci + 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    chunk_scores<T>(kst + st * CR * kstride, kstride, qs, ss, CR, np * G.plen,
                    j0 * G.plen, pos, G);
    __syncthreads();
    page_stats<T>(ss, CR, np, G, pt, ms, ls, cs, nullptr, nullptr, 0, 0);
    __syncthreads();
    chunk_pv<T, PER, false>(vst + st * CR * G.hd, pt, cs, np, G, acc, nullptr,
                            0, 0);
    __syncthreads();  // the next fetch overwrites this stage, ss and pt
  }
  if ((int)threadIdx.x >= G.hd * (G.gp / PER)) return;  // idle lanes
  const int c = threadIdx.x % G.hd, h0 = (threadIdx.x / G.hd) * PER;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (h0 + k < G.g)
      out[((size_t)b * G.nq + kvh * G.g + h0 + k) * G.hd + c] =
          from_f<T>(acc[k] / ls[h0 + k]);
}

// ---------------------------------------------------------------------------
// split A: scores and page maxima of one range, K streamed once
// ---------------------------------------------------------------------------
template <typename T>
size_t scores_smem(const Geo& G, int pps) {
  const size_t CR = (size_t)G.ch * G.plen, es = sizeof(T);
  return al16(pps * 4) + al16(G.g * G.hd * 4) + al16(G.g * CR * 4) +
         al16(G.ns * CR * (G.hd + 16 / es) * es);
}

template <typename T>
__global__ void __launch_bounds__(256)
    paged_scores(const T* __restrict__ q, const T* __restrict__ kp,
                 const int* __restrict__ bt, const int* __restrict__ positions,
                 T* __restrict__ sc, float* __restrict__ pmax, Geo G,
                 int pps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int jb = blockIdx.z * pps;
  const int CR = G.ch * G.plen, kstride = G.hd + 16 / (int)sizeof(T);
  const size_t bk = (size_t)b * G.n_kv + kvh;
  Carve cv{smem};
  int* pid = cv.take<int>(pps);
  float* qs = cv.take<float>(G.g * G.hd);
  float* ss = cv.take<float>(G.g * CR);
  T* kst = cv.take<T>(G.ns * CR * kstride);
  const int pos = positions[b];
  load_pid(pid, bt, b, jb, min(G.nb, jb + pps), G);
  const int je = min(live_pages(pos, G), jb + pps);
  if (jb >= je) return;
  const int n = je - jb;
  load_q(q, qs, b, kvh, G);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int nch = (n + G.ch - 1) / G.ch;
  auto fetch = [&](int ci) {
    const int j0 = ci * G.ch;
    stage_rows(kst + (ci & 1) * CR * kstride, kstride, kp, pid + j0,
               min(G.ch, n - j0), G, kvh);
    rt::cp_async_commit();
  };
  fetch(0);
  for (int ci = 0; ci < nch; ++ci) {
    const int j0 = ci * G.ch, np = min(G.ch, n - j0), nr = np * G.plen;
    const int row0 = (jb + j0) * G.plen;
    if (ci + 1 < nch) {
      fetch(ci + 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    chunk_scores<T>(kst + (ci & 1) * CR * kstride, kstride, qs, ss, CR, nr,
                    row0, pos, G);
    __syncthreads();
    for (int h = warp; h < G.g; h += nw) {  // page maxima, a lane a page
      if (lane < np) {
        float pm = kNegInf;
#pragma unroll 8
        for (int t = 0; t < G.plen; ++t)
          pm = fmaxf(pm, ss[h * CR + lane * G.plen + t]);
        pmax[(bk * G.g + h) * G.nb + jb + j0 + lane] = pm;
      }
    }
    // rounded scores are exact in T
    for (int i = threadIdx.x; i < G.g * nr; i += blockDim.x) {
      const int h = i / nr, r = i - h * nr;
      sc[(bk * G.g + h) * G.nb * G.plen + row0 + r] = from_f<T>(ss[h * CR + r]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// split B: prefix max, p / corr / psum / pv of one range, V streamed once
// ---------------------------------------------------------------------------
template <typename T>
size_t values_smem(const Geo& G, int pps) {
  const size_t CR = (size_t)G.ch * G.plen, es = sizeof(T);
  return al16(pps * 4) + al16(G.g * CR * 4) + al16(G.ch * G.ps * 4) +
         al16(G.g * kMaxChunk * 4) + al16(G.g * 4) +
         al16(G.ns * CR * G.hd * es);
}

template <typename T, int PER>
__global__ void __launch_bounds__(256)
    paged_values(const T* __restrict__ vp, const int* __restrict__ bt,
                 const int* __restrict__ positions, const T* __restrict__ sc,
                 const float* __restrict__ pmax, float* __restrict__ cg,
                 float* __restrict__ psg, T* __restrict__ pvg, Geo G,
                 int pps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int jb = blockIdx.z * pps;
  const int CR = G.ch * G.plen;
  const size_t bk = (size_t)b * G.n_kv + kvh;
  Carve cv{smem};
  int* pid = cv.take<int>(pps);
  float* ss = cv.take<float>(G.g * CR);
  float* pt = cv.take<float>(G.ch * G.ps);
  float* cs = cv.take<float>(G.g * kMaxChunk);
  float* ms = cv.take<float>(G.g);
  T* vst = cv.take<T>(G.ns * CR * G.hd);
  const int pos = positions[b];
  load_pid(pid, bt, b, jb, min(G.nb, jb + pps), G);
  const int je = min(live_pages(pos, G), jb + pps);
  if (jb >= je) return;
  const int n = je - jb;
  __syncthreads();

  const int nch = (n + G.ch - 1) / G.ch;
  auto fetch = [&](int ci) {
    const int j0 = ci * G.ch;
    stage_rows(vst + (ci & 1) * CR * G.hd, G.hd, vp, pid + j0,
               min(G.ch, n - j0), G, kvh);
    rt::cp_async_commit();
  };
  fetch(0);
  // the running max entering the range: the earlier pages' maxima
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int h = warp; h < G.g; h += nw) {
    float m = kNegInf;
    for (int j = lane; j < jb; j += 32)
      m = fmaxf(m, pmax[(bk * G.g + h) * G.nb + j]);
    m = rt::warp_max(m);
    if (lane == 0) ms[h] = m;
  }
  for (int ci = 0; ci < nch; ++ci) {
    const int j0 = ci * G.ch, np = min(G.ch, n - j0), nr = np * G.plen;
    const int row0 = (jb + j0) * G.plen;
    if (ci + 1 < nch) fetch(ci + 1);
    for (int i = threadIdx.x; i < G.g * nr; i += blockDim.x) {
      const int h = i / nr, r = i - h * nr;
      const float s = to_f(sc[(bk * G.g + h) * G.nb * G.plen + row0 + r]);
      ss[h * CR + r] = (row0 + r <= pos) ? s : kNegInf;
    }
    if (ci + 1 < nch)
      rt::cp_async_wait<1>();
    else
      rt::cp_async_wait<0>();
    __syncthreads();
    page_stats<T>(ss, CR, np, G, pt, ms, nullptr, cs, cg, psg, bk * G.g,
                  jb + j0);
    __syncthreads();
    chunk_pv<T, PER, true>(vst + (ci & 1) * CR * G.hd, pt, cs, np, G, nullptr,
                           pvg, bk, jb + j0);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// split C: the serial l / acc combine over pages, a block per query head and
// a thread per head-dim lane (whole warps; lanes c >= hd only stage). Tiles
// of kTP pages (pv rows by cp.async, corr
// and psum by plain loads) are staged into shared memory, the next tile in
// flight while the chain folds this one.
// ---------------------------------------------------------------------------
constexpr int kTP = 64;

template <typename T>
size_t combine_smem(const Geo& G) {  // see paged_combine's stages
  return 2 * (al16((size_t)kTP * G.hd * sizeof(T)) + 2 * al16(kTP * 4));
}

template <typename T>
__global__ void paged_combine(const int* __restrict__ positions,
                              const float* __restrict__ cg,
                              const float* __restrict__ psg,
                              const T* __restrict__ pvg, T* __restrict__ out,
                              Geo G) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  const int b = blockIdx.x / G.nq, hq = blockIdx.x - b * G.nq;
  const int kvh = hq / G.g, h = hq - kvh * G.g, c = threadIdx.x;
  const size_t bk = (size_t)b * G.n_kv + kvh;
  const int n = live_pages(positions[b], G);
  const float* cr = cg + (bk * G.g + h) * G.nb;
  const float* ps = psg + (bk * G.g + h) * G.nb;
  const T* pv = pvg + (bk * G.nb * G.g + h) * G.hd;  // page j at j * g * hd
  // two stages of [kTP pages][hd] pv, kTP corr, kTP psum
  const size_t vbytes = al16((size_t)kTP * G.hd * sizeof(T));
  const size_t sbytes = vbytes + 2 * al16(kTP * 4);
  auto vt = [&](int s) { return reinterpret_cast<T*>(smem + s * sbytes); };
  auto ct = [&](int s) {
    return reinterpret_cast<float*>(smem + s * sbytes + vbytes);
  };
  auto pt = [&](int s) { return ct(s) + kTP; };
  auto stage = [&](int tile) {
    const int j0 = tile * kTP, np = min(kTP, n - j0), s = tile & 1;
    const int cpr = G.hd / V;
    for (int i = threadIdx.x; i < np * cpr; i += blockDim.x) {
      const int j = i / cpr, e = (i - j * cpr) * V;
      rt::cp_async16(vt(s) + j * G.hd + e,
                     pv + (size_t)(j0 + j) * G.g * G.hd + e);
    }
    rt::cp_async_commit();
    for (int j = threadIdx.x; j < np; j += blockDim.x) {
      ct(s)[j] = cr[j0 + j];
      pt(s)[j] = ps[j0 + j];
    }
  };
  const int nt = (n + kTP - 1) / kTP;
  const bool lane_live = c < G.hd;
  float l = 0.f, acc = 0.f;
  if (nt > 0) stage(0);
  for (int tile = 0; tile < nt; ++tile) {
    const int np = min(kTP, n - tile * kTP), s = tile & 1;
    if (tile + 1 < nt) {
      stage(tile + 1);
      rt::cp_async_wait<1>();
    } else {
      rt::cp_async_wait<0>();
    }
    __syncthreads();
    if (lane_live) {
      const T* v = vt(s) + c;
      const float* cs = ct(s);
      const float* pss = pt(s);
#pragma unroll 8
      for (int j = 0; j < np; ++j) {
        const float cj = cs[j];
        l = __fadd_rn(round_t<T>(__fmul_rn(l, cj)), pss[j]);
        acc = __fadd_rn(round_t<T>(__fmul_rn(acc, cj)), to_f(v[j * G.hd]));
      }
    }
    __syncthreads();  // the next stage() overwrites this tile
  }
  if (lane_live) out[((size_t)b * G.nq + hq) * G.hd + c] = from_f<T>(acc / l);
}

template <typename T, int PER>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* pos, void* out, int B, int nq,
                   int n_kv, int hd, int plen, int nb, float scale, int pps,
                   void* sc, float* pmax, float* corr, float* psum, void* pv,
                   cudaStream_t stream) {
  const int g = nq / n_kv, slices = (g + PER - 1) / PER;
  const int threads = whole_warps(hd * slices);
  const bool one = pps >= nb;
  const int span = one ? nb : pps;  // pages one block walks, at most
  Geo G{nq, n_kv, g, hd, plen, nb, 0, 0, slices * PER, 0, scale};
  G.ch = std::min({kMaxChunk, std::max(1, kChunkRows / plen), span});
  auto need = [&](Geo& x) {
    x.ns = span > x.ch ? 2 : 1;
    x.ps = plen * x.gp + 4;  // + 4: pages of one warp's writes hit 8 banks
    return one ? fused_smem<T>(x)
               : std::max(scores_smem<T>(x, pps), values_smem<T>(x, pps));
  };
  while (G.ch > 1 && need(G) > kSmemCap) G.ch >>= 1;
  if (need(G) > kSmemCap) return cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(kp);
  const T* vt = static_cast<const T*>(vp);
  T* o = static_cast<T*>(out);
  cudaError_t e;
  if (one) {
    const size_t smem = fused_smem<T>(G);
    if ((e = rt::allow_smem(paged_fused<T, PER>, smem)) != cudaSuccess)
      return e;
    paged_fused<T, PER><<<dim3(B, n_kv), threads, smem, stream>>>(
        qt, kt, vt, bt, pos, o, G);
    return cudaGetLastError();
  }
  const dim3 grid(B, n_kv, (nb + pps - 1) / pps);
  const size_t sa = scores_smem<T>(G, pps), sb = values_smem<T>(G, pps);
  const size_t sc_ = combine_smem<T>(G);
  if ((e = rt::allow_smem(paged_scores<T>, sa)) != cudaSuccess) return e;
  if ((e = rt::allow_smem(paged_values<T, PER>, sb)) != cudaSuccess) return e;
  if ((e = rt::allow_smem(paged_combine<T>, sc_)) != cudaSuccess) return e;
  T* sct = static_cast<T*>(sc);
  T* pvt = static_cast<T*>(pv);
  paged_scores<T><<<grid, threads, sa, stream>>>(qt, kt, bt, pos, sct, pmax, G,
                                                 pps);
  paged_values<T, PER><<<grid, threads, sb, stream>>>(
      vt, bt, pos, sct, pmax, corr, psum, pvt, G, pps);
  paged_combine<T><<<B * nq, whole_warps(hd), sc_, stream>>>(pos, corr, psum,
                                                              pvt, o, G);
  return cudaGetLastError();
}

// heads a thread takes in pv: g over as many hd-thread slices as keep a
// block at 256 threads or under, rounded up to 4, 8 or 16
template <typename T>
cudaError_t launch_any(const void* q, const void* kp, const void* vp,
                       const int* bt, const int* pos, void* out, int B, int nq,
                       int n_kv, int hd, int plen, int nb, float scale,
                       int pps, void* sc, float* pmax, float* corr,
                       float* psum, void* pv, cudaStream_t stream) {
  const int g = nq / n_kv;
  const int s = std::max(1, std::min(256 / hd, g));
  const int per = (g + s - 1) / s;
  auto go = [&](auto tag) {
    return launch<T, decltype(tag)::value>(q, kp, vp, bt, pos, out, B, nq,
                                           n_kv, hd, plen, nb, scale, pps, sc,
                                           pmax, corr, psum, pv, stream);
  };
  if (per <= 4) return go(std::integral_constant<int, 4>());
  if (per <= 8) return go(std::integral_constant<int, 8>());
  return go(std::integral_constant<int, 16>());
}

}  // namespace

// Plain C entry point (bound with ctypes); ``scale`` is 1/sqrt(hd) rounded
// to f32 by the caller. ``pages_per_split`` >= nb runs the one-range form
// (the scratch pointers are then unused and may be null); below nb the
// split form, with scratch from the caller: scores [B, n_kv, g, nb * plen]
// and pv [B, n_kv, nb, g, hd] in the input type, pmax / corr / psum
// [B, n_kv, g, nb] f32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue when a chunk of one page does not fit in shared
// memory. The caller guarantees hd % 16 == 0, hd <= 256, nq % n_kv == 0,
// nq / n_kv <= 16 and 16-byte aligned arenas.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_table, const int* positions, void* out, int B, int nq,
    int n_kv, int hd, int plen, int nb, float scale, int is_bf16,
    int pages_per_split, void* scores, float* pmax, float* corr, float* psum,
    void* pv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_any<bf16>(q, k_pages, v_pages, block_table, positions, out, B,
                        nq, n_kv, hd, plen, nb, scale, pages_per_split, scores,
                        pmax, corr, psum, pv, s);
  return launch_any<float>(q, k_pages, v_pages, block_table, positions, out, B, nq,
                       n_kv, hd, plen, nb, scale, pages_per_split, scores,
                       pmax, corr, psum, pv, s);
}
