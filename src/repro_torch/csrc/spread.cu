// FFT-repulsion spread: scatter per-point charges onto the node lattice
// through the separable 3x3 Lagrange stencil.
//
// Replaces: src/repro/kernels/interp_kernel.py::_spread_kernel (entry
//   spread_to_grid_pallas):
//     grid[a, b, c] += wx[i, a - bx_i] * wy[i, b - by_i] * ch[i, c]
//   for the 9 taps (a, b) of each point i.  The TPU has no scatter, so the
//   Pallas kernel builds one-hot [TILE, G] tap matrices and multiplies them
//   on the MXU.  Hopper has atomics; nothing of that form is carried over.
//
// Bound on an H100: bytes, and at the main path's size launch latency.  A
// point reads 44 bytes (2 int32 base, 6 weights, 3 charges) and the
// [nodes, nodes, C] grid is written once: 70 000 points and 97 x 97 x 3
// nodes move about 3.2 MB, about 1 us of memory time.
//
// Design: the products (wx * wy) * ch are the plain version's, operation
// for operation; only the order of the sums differs.
// * lattice fits in a block's shared memory (97^2 x 3 x 4 B = 110 KiB at
//   the default 48 boxes, above 48 KiB, so dynamic shared memory with the
//   opt-in): a few blocks each walk a grid-strided share of the points,
//   add into a private copy of the lattice with shared-memory atomics, and
//   flush its non-zero entries into the global grid with atomicAdd.  Few
//   blocks keep the flush small: the global atomics are at most
//   blocks x nodes^2 x C, against 27 a point without the private copy.
// * lattice larger than the opt-in limit (257^2 x 3 x 4 B = 775 KiB at
//   MAX_N_BOXES = 128): one thread a point, 27 atomicAdds into the global
//   grid.
// Float atomics make the order of each node's sum vary from run to run,
// so the result is not bit-reproducible: it is held to the plain version
// with a relative tolerance (exact on lattice-node points with integer
// charges, where every partial sum is an exact integer).
//
// The caller passes a zeroed grid.  Taps outside the lattice are skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 3;                     // Lagrange nodes per box per dim
constexpr int SHARED_THREADS = 512;
constexpr int POINTS_PER_BLOCK = 4096;   // target share of one private lattice
constexpr int GLOBAL_THREADS = 256;

__device__ __forceinline__ void spread_point(
    int i, const int32_t* __restrict__ base, const float* __restrict__ wx,
    const float* __restrict__ wy, const float* __restrict__ ch, float* grid,
    int nodes, int c) {
  const int bx = base[2 * i];
  const int by = base[2 * i + 1];
  float wxi[P], wyi[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    wxi[t] = wx[P * i + t];
    wyi[t] = wy[P * i + t];
  }
  const float* chi = ch + (size_t)i * c;
#pragma unroll
  for (int a = 0; a < P; ++a) {
    const int gx = bx + a;
    if (gx < 0 || gx >= nodes) continue;
#pragma unroll
    for (int b = 0; b < P; ++b) {
      const int gy = by + b;
      if (gy < 0 || gy >= nodes) continue;
      const float w = __fmul_rn(wxi[a], wyi[b]);
      float* node = grid + ((size_t)gx * nodes + gy) * c;
      for (int k = 0; k < c; ++k) atomicAdd(node + k, __fmul_rn(w, chi[k]));
    }
  }
}

__global__ void __launch_bounds__(SHARED_THREADS)
spread_shared_kernel(const int32_t* __restrict__ base, const float* __restrict__ wx,
                     const float* __restrict__ wy, const float* __restrict__ ch,
                     float* __restrict__ grid, int n, int nodes, int c) {
  extern __shared__ float lattice[];
  const int size = nodes * nodes * c;
  for (int j = threadIdx.x; j < size; j += blockDim.x) lattice[j] = 0.0f;
  __syncthreads();
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    spread_point(i, base, wx, wy, ch, lattice, nodes, c);
  __syncthreads();
  for (int j = threadIdx.x; j < size; j += blockDim.x) {
    const float v = lattice[j];
    if (v != 0.0f) atomicAdd(grid + j, v);
  }
}

__global__ void __launch_bounds__(GLOBAL_THREADS)
spread_global_kernel(const int32_t* __restrict__ base, const float* __restrict__ wx,
                     const float* __restrict__ wy, const float* __restrict__ ch,
                     float* grid, int n, int nodes, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) spread_point(i, base, wx, wy, ch, grid, nodes, c);
}

}  // namespace

// base [n, 2] int32, wx / wy [n, 3] fp32, charges [n, c] fp32 ->
// grid [nodes, nodes, c] fp32, which the caller has zeroed; all row-major.
// Returns a cudaError_t (0 on success).
extern "C" int fft_spread(const int32_t* base, const float* wx, const float* wy,
                          const float* charges, float* grid, int n, int nodes,
                          int c, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nodes <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = (size_t)nodes * nodes * c * sizeof(float);
  if (bytes <= (size_t)optin) {
    err = cudaFuncSetAttribute(spread_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    int blocks = (n + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK;
    if (blocks > 2 * sms) blocks = 2 * sms;
    spread_shared_kernel<<<blocks, SHARED_THREADS, bytes, s>>>(
        base, wx, wy, charges, grid, n, nodes, c);
  } else {
    spread_global_kernel<<<(n + GLOBAL_THREADS - 1) / GLOBAL_THREADS, GLOBAL_THREADS, 0, s>>>(
        base, wx, wy, charges, grid, n, nodes, c);
  }
  return (int)cudaGetLastError();
}
