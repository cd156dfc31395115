// Attractive forces over the symmetric ELL rows, paper Algorithm 2.
//
// Replaces: src/repro/kernels/attractive_kernel.py::_attractive_kernel
//   (entry attractive_forces_ell_pallas):
//     pq = p_ij / (1 + d_ij^2),  F_i = sum_j pq (y_i - y_j),
//     kl_i = sum_j p_ij log1p(d_ij^2).
//   The TPU version gathers y[cols] with XLA outside the kernel; here the
//   kernel does the gather itself, so the [N, W, 2] gathered copy is never
//   written to memory.
//
// Bound on an H100: bytes.  Each entry reads a 4-byte column index and a
// 4-byte value (N * W * 8 bytes) for about a dozen fp32 operations; y
// (N * 8 bytes, 560 KB at 70 000 points) stays resident in the 50 MB L2,
// so the pseudo-random y[j] reads are L2 hits, not device-memory traffic.
//
// Design: one warp per row.  Lane l takes entries l, l + 32, ... so each
// warp reads its row's cols and vals as coalesced 128-byte lines; the
// force and KL partial sums are combined with warp shuffles and lane 0
// writes F_i and the row's KL partial.  The caller sums the [N] partials
// (torch.sum), so the result is deterministic: no atomics anywhere.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;   // rows per block of 256 threads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
attractive_kernel(const float* __restrict__ y, const int32_t* __restrict__ cols,
                  const float* __restrict__ vals, float* __restrict__ force,
                  float* __restrict__ kl_rows, int n, int w) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;   // warp-uniform
  const float yx = y[2 * row];
  const float yy = y[2 * row + 1];
  const int32_t* c = cols + (size_t)row * w;
  const float* v = vals + (size_t)row * w;
  float fx = 0.0f, fy = 0.0f, kl = 0.0f;
  for (int j = lane; j < w; j += 32) {
    const int32_t col = c[j];
    const float p = v[j];
    const float dx = yx - y[2 * col];
    const float dy = yy - y[2 * col + 1];
    const float d2 = dx * dx + dy * dy;
    const float pq = p / (1.0f + d2);
    fx += pq * dx;
    fy += pq * dy;
    kl += p * log1pf(d2);
  }
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  kl = warp_sum(kl);
  if (lane == 0) {
    force[2 * row] = fx;
    force[2 * row + 1] = fy;
    kl_rows[row] = kl;
  }
}

}  // namespace

// y [n, 2] fp32, cols [n, w] int32 (every entry in [0, n)), vals [n, w]
// fp32 -> force [n, 2], kl_rows [n].  Returns cudaGetLastError().
extern "C" int attractive_ell(const float* y, const int32_t* cols,
                              const float* vals, float* force, float* kl_rows,
                              int n, int w, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + WARPS - 1) / WARPS;
  attractive_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      y, cols, vals, force, kl_rows, n, w);
  return (int)cudaGetLastError();
}
