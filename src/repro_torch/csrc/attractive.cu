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
// Bound on an H100: bytes.  Each real entry reads a 4-byte column index
// and a 4-byte value for about a dozen fp32 operations; y (N * 8 bytes,
// 560 KB at 70 000 points) stays resident in the 50 MB L2, so the
// pseudo-random y[j] reads are L2 hits, not device-memory traffic; but
// each moves a 32-byte L2 sector for 8 useful bytes, and those sectors,
// not the kernel's shape, keep it above the bytes bound.  The
// symmetrized ELL puts each row's real entries first and pads the row to
// the widest one (col = row, val = 0); at the main path's shapes more than
// half of the [N, W] planes is padding.
//
// Design: one warp per row, which walks only the row's real entries
// (row_len[row] of them; all W without row_len).  Each lane loads the
// col / val pairs of UNROLL of its entries (l, l + 32, ...: coalesced
// 128-byte lines) before it issues their y[col] reads, one 8-byte float2
// read each, so UNROLL gathers are in flight instead of a chain of
// dependent loads.  The force and KL partial sums are combined with warp
// shuffles and lane 0 writes F_i and the row's KL partial.  The caller
// sums the [N] partials (torch.sum), so the result is deterministic: no
// atomics anywhere.  row0 serves a shard's rows of the graph against the
// global y (the sharded gradient): row i of cols is the point y[row0 + i],
// so that point is y_i and a padding slot's column; cols, vals, row_len,
// force and kl_rows stay indexed by the local row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;    // rows per block of 256 threads
constexpr int UNROLL = 4;   // entries a lane has in flight

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
attractive_kernel(const float2* __restrict__ y, const int32_t* __restrict__ cols,
                  const float* __restrict__ vals, const int32_t* __restrict__ row_len,
                  float2* __restrict__ force, float* __restrict__ kl_rows, int n, int w,
                  int row0) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;   // warp-uniform
  const int len = row_len ? min(__ldg(row_len + row), w) : w;   // < 0: no entry
  const int self = row0 + row;   // the row's point in y
  const float2 yi = __ldg(y + self);
  const int32_t* c = cols + (size_t)row * w;
  const float* v = vals + (size_t)row * w;
  float fx = 0.0f, fy = 0.0f, kl = 0.0f;
  for (int base = 0; base < len; base += 32 * UNROLL) {   // warp-uniform trip count
    int32_t col[UNROLL];
    float p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + 32 * u + lane;
      const bool real = j < len;
      // a slot past the row's end is a padding entry: y_j = y_i, p = 0
      col[u] = real ? __ldg(c + j) : self;
      p[u] = real ? __ldg(v + j) : 0.0f;
    }
    float2 yj[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) yj[u] = __ldg(y + col[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float dx = yi.x - yj[u].x;
      const float dy = yi.y - yj[u].y;
      const float d2 = dx * dx + dy * dy;
      const float pq = p[u] / (1.0f + d2);
      fx += pq * dx;
      fy += pq * dy;
      kl += p[u] * log1pf(d2);
    }
  }
  fx = warp_sum(fx);
  fy = warp_sum(fy);
  kl = warp_sum(kl);
  if (lane == 0) {
    force[row] = make_float2(fx, fy);
    kl_rows[row] = kl;
  }
}

}  // namespace

// y [>= row0 + n, 2] fp32 (8-byte aligned), cols [n, w] int32 (every
// entry a row of y), vals [n, w] fp32, row_len [n] int32 or null (every
// row w long) -> force [n, 2], kl_rows [n]; row i is y's point row0 + i.
// Entries at or past row_len[i], clamped into [0, w], are not read.
// Returns cudaGetLastError().
extern "C" int attractive_ell(const float* y, const int32_t* cols, const float* vals,
                              const int32_t* row_len, float* force, float* kl_rows,
                              int n, int w, int row0, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int blocks = (n + WARPS - 1) / WARPS;
  attractive_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(y), cols, vals, row_len,
      reinterpret_cast<float2*>(force), kl_rows, n, w, row0);
  return (int)cudaGetLastError();
}
