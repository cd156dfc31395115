// Fused perplexity binary search, one row per warp (paper §3.2).
//
// Replaces: src/repro/kernels/bsp_kernel.py::_bsp_kernel (entry
//   binary_search_perplexity_pallas): the whole per-row bisection for
//   beta = 1 / (2 sigma^2) with the row-min shift and row-mean scale, then
//   cond_p = p / sum(p) and beta / scale.
//
// Bound on an H100: operations.  d2 [N, K] is read once and cond_p written
// once (8 bytes an entry), while every entry costs 65 expf (64 bisection
// steps and the final normalisation) plus a handful of fp32 operations each
// time, so the SFU exponentials and fp32 pipes bound it, not memory.
//
// Design: one warp per row.  K <= 1024, so a row is at most 32 values a
// lane, held in registers for all 65 passes (VPL, the values per lane, is
// a template parameter: 1, 2, 4, 8, 16 or 32).  The row min, the mean and
// every pass's sum(p) and sum(d2n * p) are warp-shuffle reductions; no
// shared memory, no atomics, nothing leaves the registers between passes.
// Lanes past K are masked (they contribute 0), never zero-padded.  The
// branch logic is that of bsp_kernel.py: too_high = h > log(u) + tol.
// expf / logf, not the fast intrinsics, because the result is held to the
// plain version at rtol 1e-5.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;   // rows per block of 128 threads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int VPL>
__global__ void __launch_bounds__(WARPS * 32)
bsp_kernel(const float* __restrict__ d2, float* __restrict__ cond_p,
           float* __restrict__ beta_out, int n, int k, float log_u, float tol,
           int iters) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;   // whole warp exits together: row is warp-uniform
  const float* src = d2 + (size_t)row * k;

  float x[VPL];
  float mn = INFINITY;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = lane + 32 * v;
    x[v] = (j < k) ? src[j] : 0.0f;
    if (j < k) mn = fminf(mn, x[v]);
  }
  mn = warp_min(mn);
  float s = 0.0f;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = lane + 32 * v;
    x[v] = (j < k) ? x[v] - mn : 0.0f;
    s += x[v];
  }
  const float scale = fmaxf(warp_sum(s) / (float)k, 1e-30f);
#pragma unroll
  for (int v = 0; v < VPL; ++v) x[v] = x[v] / scale;   // d2n; masked lanes 0

  const float target = log_u + tol;
  float beta = 1.0f, bmin = 0.0f, bmax = INFINITY;
  for (int it = 0; it < iters; ++it) {
    float sp = 0.0f, sdp = 0.0f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int j = lane + 32 * v;
      const float p = (j < k) ? expf(-x[v] * beta) : 0.0f;
      sp += p;
      sdp += x[v] * p;
    }
    const float sum_p = fmaxf(warp_sum(sp), 1e-30f);
    const float h = logf(sum_p) + beta * warp_sum(sdp) / sum_p;
    const bool too_high = h > target;   // entropy too high -> sharpen kernel
    if (too_high) bmin = beta; else bmax = beta;
    const float up = isinf(bmax) ? beta * 2.0f : 0.5f * (beta + bmax);
    const float down = (bmin <= 0.0f) ? beta * 0.5f : 0.5f * (beta + bmin);
    beta = too_high ? up : down;
  }

  float p[VPL];
  float sp = 0.0f;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = lane + 32 * v;
    p[v] = (j < k) ? expf(-x[v] * beta) : 0.0f;
    sp += p[v];
  }
  const float sum_p = fmaxf(warp_sum(sp), 1e-30f);
  float* dst = cond_p + (size_t)row * k;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int j = lane + 32 * v;
    if (j < k) dst[j] = p[v] / sum_p;
  }
  if (lane == 0) beta_out[row] = beta / scale;
}

template <int VPL>
void launch(const float* d2, float* cond_p, float* beta, int n, int k,
            float log_u, float tol, int iters, cudaStream_t stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  bsp_kernel<VPL><<<blocks, WARPS * 32, 0, stream>>>(d2, cond_p, beta, n, k,
                                                     log_u, tol, iters);
}

}  // namespace

// d2 [n, k] fp32 row-major -> cond_p [n, k], beta [n].  1 <= k <= 1024.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported k).
extern "C" int bsp_search(const float* d2, float* cond_p, float* beta, int n,
                          int k, float log_u, float tol, int iters,
                          void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 0 || k > 1024) return (int)cudaErrorInvalidValue;
  if (k <= 32) launch<1>(d2, cond_p, beta, n, k, log_u, tol, iters, s);
  else if (k <= 64) launch<2>(d2, cond_p, beta, n, k, log_u, tol, iters, s);
  else if (k <= 128) launch<4>(d2, cond_p, beta, n, k, log_u, tol, iters, s);
  else if (k <= 256) launch<8>(d2, cond_p, beta, n, k, log_u, tol, iters, s);
  else if (k <= 512) launch<16>(d2, cond_p, beta, n, k, log_u, tol, iters, s);
  else launch<32>(d2, cond_p, beta, n, k, log_u, tol, iters, s);
  return (int)cudaGetLastError();
}
