// Fused perplexity binary search, G lanes a row (paper §3.2).
//
// Replaces: src/repro/kernels/bsp_kernel.py::_bsp_kernel (entry
//   binary_search_perplexity_pallas): the whole per-row bisection for
//   beta = 1 / (2 sigma^2) with the row-min shift and row-mean scale, then
//   cond_p = p / sum(p) and beta / scale.
//
// Bound on an H100: operations, the exponentials.  d2 [N, K] is read once
// and cond_p written once (8 bytes an entry), while every entry costs 65
// exponentials (64 bisection steps and the final normalisation), each one
// result of the SFU (16 a clock an SM), plus a handful of fp32 operations.
//
// Design: a row is held by a group of G lanes (G a power of two, 32 / G
// rows a warp), each lane holding VALUES values in registers for all 65
// passes, G x VALUES just covering K (ops.bsp_plan picks both from K;
// VALUES is a template parameter).  The per-row work of a pass (two group
// reductions of log2(G) shuffles, a logf, a division and the bracket
// update) is issued once for 32 / G rows, not once a row as with a warp a
// row.  A warp's rows are one contiguous span of d2: it is staged through
// shared memory by coalesced 4-byte loads (rows of K floats are at no
// 16-byte boundary in general) and cond_p leaves the same way.  A slot
// past K holds MASKED, whose exponential is exactly 0, so the 65 passes
// run with no mask and no branch.  Each G has a fixed reduction order (a
// butterfly, the same sum on every lane of a group), so the result is
// deterministic.  The branch logic is that of bsp_kernel.py: too_high =
// h > log(u) + tol.  The bisection's exponentials are exp2f of d2n
// pre-scaled by log2(e) (fewer instructions than expf); the final
// normalisation is expf of d2n, and logf and the divisions are the
// accurate ones: the result is held to the plain version at rtol 1e-5.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;          // warps a block of 128 threads
constexpr float MASKED = 1e30f;   // d2n of a slot past K: exp(-MASKED beta) = 0 exactly

// Butterfly over the row's group of G lanes (xor partners stay inside an
// aligned group): every lane of the group ends with the same sum.
__device__ __forceinline__ float group_sum(float v, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float group_min(float v, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VALUES: the values a lane holds (G x VALUES >= K); lg = log2(G).
template <int VALUES>
__global__ void __launch_bounds__(WARPS * 32)
bsp_kernel(const float* __restrict__ d2, float* __restrict__ cond_p,
           float* __restrict__ beta_out, int n, int k, int lg, float log_u,
           float tol, int iters) {
  __shared__ float span_all[WARPS][32 * VALUES];   // 32 / G rows of K <= G x VALUES
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lg;
  const int rows = 32 >> lg;
  const int row0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * rows;
  if (row0 >= n) return;   // whole warp exits together: row0 is warp-uniform
  const int nrows = min(rows, n - row0);
  const int words = nrows * k;
  float* span = span_all[threadIdx.x >> 5];
  const float* src = d2 + (size_t)row0 * k;
  for (int w = lane; w < words; w += 32) span[w] = src[w];
  __syncwarp();

  const int r = lane >> lg;          // this lane's row in the warp
  const int g = lane & (lanes - 1);  // its place in the row's group
  const bool live = r < nrows;
  float* mine = span + r * k;

  float x[VALUES];
  float mn = INFINITY;
#pragma unroll
  for (int v = 0; v < VALUES; ++v) {
    const int j = g + (v << lg);
    x[v] = (live && j < k) ? mine[j] : 0.0f;
    if (live && j < k) mn = fminf(mn, x[v]);
  }
  mn = group_min(mn, lanes);
  float s = 0.0f;
#pragma unroll
  for (int v = 0; v < VALUES; ++v) {
    const int j = g + (v << lg);
    x[v] = (live && j < k) ? x[v] - mn : 0.0f;
    s += x[v];
  }
  const float scale = fmaxf(group_sum(s, lanes) / (float)k, 1e-30f);
#pragma unroll
  for (int v = 0; v < VALUES; ++v) {
    const int j = g + (v << lg);
    // d2n; a masked slot adds exp(-MASKED beta) = 0 and MASKED x 0 = 0 to
    // the sums (beta >= 2^-64 > 104 / MASKED), so the passes need no mask
    x[v] = (live && j < k) ? x[v] / scale : MASKED;
  }

  float x2[VALUES];                  // d2n log2(e): exp2f(-x2 beta) = exp(-d2n beta)
#pragma unroll
  for (int v = 0; v < VALUES; ++v) x2[v] = x[v] * 1.4426950408889634f;

  const float target = log_u + tol;
  float beta = 1.0f, bmin = 0.0f, bmax = INFINITY;
  for (int it = 0; it < iters; ++it) {
    float sp = 0.0f, sdp = 0.0f;
#pragma unroll
    for (int v = 0; v < VALUES; ++v) {
      const float p = exp2f(-x2[v] * beta);
      sp += p;
      sdp += x[v] * p;
    }
    const float sum_p = fmaxf(group_sum(sp, lanes), 1e-30f);
    const float h = logf(sum_p) + beta * group_sum(sdp, lanes) / sum_p;
    const bool too_high = h > target;   // entropy too high -> sharpen kernel
    if (too_high) bmin = beta; else bmax = beta;
    const float up = isinf(bmax) ? beta * 2.0f : 0.5f * (beta + bmax);
    const float down = (bmin <= 0.0f) ? beta * 0.5f : 0.5f * (beta + bmin);
    beta = too_high ? up : down;
  }

  float sp = 0.0f;
#pragma unroll
  for (int v = 0; v < VALUES; ++v) {
    x[v] = expf(-x[v] * beta);       // p; 0 in masked slots
    sp += x[v];
  }
  const float sum_p = fmaxf(group_sum(sp, lanes), 1e-30f);
  __syncwarp();                      // every lane has read the span
#pragma unroll
  for (int v = 0; v < VALUES; ++v) {
    const int j = g + (v << lg);
    if (live && j < k) mine[j] = x[v] / sum_p;
  }
  __syncwarp();
  float* dst = cond_p + (size_t)row0 * k;
  for (int w = lane; w < words; w += 32) dst[w] = span[w];
  if (live && g == 0) beta_out[row0 + r] = beta / scale;
}

template <int VALUES>
void launch(const float* d2, float* cond_p, float* beta, int n, int k, int lg,
            float log_u, float tol, int iters, cudaStream_t stream) {
  const int rows_a_block = WARPS * (32 >> lg);
  const int blocks = (n + rows_a_block - 1) / rows_a_block;
  bsp_kernel<VALUES><<<blocks, WARPS * 32, 0, stream>>>(d2, cond_p, beta, n, k, lg,
                                                        log_u, tol, iters);
}

}  // namespace

// d2 [n, k] fp32 row-major -> cond_p [n, k], beta [n].  1 <= k <= 1024.
// lanes (G, a power of two <= 32) and values (one of 1, 2, 3, 4, 6, 8, 12,
// 16, 24, 32, with lanes x values >= k) are the launch plan of
// ops.bsp_plan.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported k or plan).
extern "C" int bsp_search(const float* d2, float* cond_p, float* beta, int n,
                          int k, float log_u, float tol, int iters, int lanes,
                          int values, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 0 || k > 1024 || lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) ||
      lanes * values < k)
    return (int)cudaErrorInvalidValue;
  const int lg = __builtin_ctz(lanes);
  switch (values) {
    case 1: launch<1>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 2: launch<2>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 3: launch<3>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 4: launch<4>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 6: launch<6>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 8: launch<8>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 12: launch<12>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 16: launch<16>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 24: launch<24>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    case 32: launch<32>(d2, cond_p, beta, n, k, lg, log_u, tol, iters, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
