// Pairwise squared distances, the KNN distance tile (paper §3.1).
//
// Replaces: src/repro/kernels/pairwise_kernel.py::_pairwise_kernel
//   (entry pairwise_sq_dists_pallas), which computes
//   out[i, j] = max(|q_i|^2 + |c_j|^2 - 2 q_i . c_j, 0) on the TPU's MXU.
//
// Bound on an H100: operations.  The tile does 2*Q*C*D fp32 operations on
// (Q + C)*D inputs; at the main path's shapes (D = 784) that is far above
// the card's balance point, so the fp32 SIMT rate bounds it.  TF32 tensor
// cores would be faster but keep ~3 decimal digits, and the |q|^2 + |c|^2
// - 2qc form cancels, which costs KNN recall; so the dot products stay in
// full fp32 on the CUDA cores.
//
// Design: a shared-memory-tiled SIMT product.  Each block of 256 threads
// owns a 64 x 64 output tile; each thread accumulates a 4 x 4 micro-tile
// in registers while the block walks D in chunks of 16, staging a 16 x 64
// slice of q and of c in shared memory (stored k-major, so the inner loop
// reads rows of both as broadcasts / consecutive words).  The epilogue
// adds the two norms and clamps at 0 in the same kernel.  Ragged edges
// (Q, C or D not a multiple of the tile) are masked, never padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;   // output rows and columns per block
constexpr int KC = 16;     // D chunk staged in shared memory
constexpr int MICRO = 4;   // each thread: MICRO x MICRO outputs
constexpr int THREADS = (TILE / MICRO) * (TILE / MICRO);   // 256

__global__ void __launch_bounds__(THREADS)
pairwise_kernel(const float* __restrict__ q, const float* __restrict__ c,
                const float* __restrict__ qn, const float* __restrict__ cn,
                float* __restrict__ out, int nq, int nc, int d) {
  __shared__ float qs[KC][TILE + 4];
  __shared__ float cs[KC][TILE + 4];

  const int tid = threadIdx.x;
  const int tx = tid % (TILE / MICRO);   // column group
  const int ty = tid / (TILE / MICRO);   // row group
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;

  float acc[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i)
#pragma unroll
    for (int j = 0; j < MICRO; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += KC) {
    // 64 rows x 16 depth per operand = 1024 values, 4 per thread.  A warp
    // reads 2 rows x 16 consecutive floats of each operand.
#pragma unroll
    for (int r = 0; r < (TILE * KC) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int kk = e % KC;
      const int rr = e / KC;
      const int kg = k0 + kk;
      const int qi = row0 + rr;
      const int ci = col0 + rr;
      qs[kk][rr] = (qi < nq && kg < d) ? q[(size_t)qi * d + kg] : 0.0f;
      cs[kk][rr] = (ci < nc && kg < d) ? c[(size_t)ci * d + kg] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[MICRO], b[MICRO];
#pragma unroll
      for (int i = 0; i < MICRO; ++i) a[i] = qs[kk][ty + i * (TILE / MICRO)];
#pragma unroll
      for (int j = 0; j < MICRO; ++j) b[j] = cs[kk][tx + j * (TILE / MICRO)];
#pragma unroll
      for (int i = 0; i < MICRO; ++i)
#pragma unroll
        for (int j = 0; j < MICRO; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
    const int qi = row0 + ty + i * (TILE / MICRO);
    if (qi >= nq) continue;
    const float qni = qn[qi];
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int ci = col0 + tx + j * (TILE / MICRO);
      if (ci >= nc) continue;
      const float v = qni + cn[ci] - 2.0f * acc[i][j];
      out[(size_t)qi * nc + ci] = fmaxf(v, 0.0f);
    }
  }
}

}  // namespace

// out [nq, nc] = max(qn[:, None] + cn[None, :] - 2 q c^T, 0); all fp32,
// row-major and contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int pairwise_sq_dists(const float* q, const float* c, const float* qn,
                                 const float* cn, float* out, int nq, int nc,
                                 int d, void* stream) {
  if (nq <= 0 || nc <= 0) return (int)cudaSuccess;
  dim3 grid((nc + TILE - 1) / TILE, (nq + TILE - 1) / TILE);
  pairwise_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(q, c, qn, cn, out,
                                                              nq, nc, d);
  return (int)cudaGetLastError();
}
