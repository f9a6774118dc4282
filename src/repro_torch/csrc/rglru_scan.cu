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
// Bound: bytes. Every element of a and b is read once and every h written
// once (12 bytes a step a channel), against 2 flops. Design: the TPU tiles
// time into VMEM blocks and carries h in scratch across a sequential grid
// axis; here the time axis becomes a loop inside one thread per (b, d)
// channel, and a warp covers 32 consecutive d, so every load of a[b, t, :]
// and b[b, t, :] and every store of h is coalesced. The loads do not depend
// on the carry, so the loop is unrolled by kUnroll steps: all of a chunk's
// loads issue before its dependent chain of multiply-adds. Any S >= 1 and
// any D are accepted (the ragged chunk and the ragged warp are guarded).
// A long prompt at small B leaves most SMs idle; a chunked two-pass scan
// over time is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels per block (two warps)
constexpr int kUnroll = 8;    // time steps whose loads issue together

__global__ void rglru_scan_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  const float* __restrict__ h0,
                                  float* __restrict__ h, int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)bi * S * D + d;
  float carry = h0 != nullptr ? h0[(size_t)bi * D + d] : 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(a + base + (size_t)(t + u) * D);
      bv[u] = __ldg(b + base + (size_t)(t + u) * D);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
      h[base + (size_t)(t + u) * D] = carry;
    }
  }
  for (; t < S; ++t) {
    const size_t i = base + (size_t)t * D;
    carry = __fadd_rn(__fmul_rn(__ldg(a + i), carry), __ldg(b + i));
    h[i] = carry;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Pointers are device pointers to
// contiguous f32 tensors; h0 may be null. Returns cudaGetLastError().
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, float* h, int B, int S,
                                 int D, void* stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, h, S, D);
  return cudaGetLastError();
}
