// FFT-repulsion gather: interpolate node potentials back at the points
// through the separable 3x3 Lagrange stencil (the transpose of spread).
//
// Replaces: src/repro/kernels/interp_kernel.py::_gather_kernel (entry
//   gather_from_grid_pallas):
//     phi[i, c] = sum_(a, b) wx[i, a] * wy[i, b] * pot[bx_i + a, by_i + b, c]
//   The TPU kernel multiplies one-hot [TILE, G] tap matrices with the
//   lattice on the MXU, because it has no gather; here each thread reads
//   its 9 taps directly.
//
// Bound on an H100: bytes, and at the main path's size latency and L2.  A
// point reads 32 bytes (base and weights) and writes 4 x 4 bytes, and the
// [97, 97, 4] potential (147 KiB) is read once: 70 000 points move about
// 3.5 MB, about 1 us of memory time.  But the 9 taps a point are three
// 48-byte runs at pseudo-random places of the potential: six 32-byte L2
// sectors a point, ~13 MB of L2 reads for 70 000 points, and they depend
// on the point's record: two round trips in series.
//
// Design: one thread a point, 128-thread CTAs.  A thread loads its point's
// record (base, wx, wy) and, if its 3x3 box lies on the lattice
// (interp_coords makes no other), issues the nine float4 taps as
// independent non-coherent loads with no branch between them; a box that
// overhangs takes the checked path, which skips taps off the lattice.
// One float4 store a point.  No atomics, deterministic.
// The products wx * wy and w * pot and the sum over the 9 taps in (a, b)
// order use __fmul_rn / __fadd_rn, so nvcc cannot contract them into FMAs
// that would round differently from the plain version's multiply-then-sum;
// both paths sum in the same order, so the result does not depend on the
// path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 3;            // Lagrange nodes per box per dim
constexpr int THREADS = 128;    // threads a CTA, one a point

__device__ __forceinline__ void add_tap(float4& acc, float4 v, float w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w));
}

__global__ void __launch_bounds__(THREADS)
gather_kernel(const float4* __restrict__ pot, const int32_t* __restrict__ base,
              const float* __restrict__ wx, const float* __restrict__ wy,
              float4* __restrict__ phi, int n, int nodes) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int bx = base[2 * (size_t)i];
  const int by = base[2 * (size_t)i + 1];
  float wxi[P], wyi[P];
#pragma unroll
  for (int a = 0; a < P; ++a) {
    wxi[a] = wx[P * (size_t)i + a];
    wyi[a] = wy[P * (size_t)i + a];
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (bx >= 0 && by >= 0 && bx + P <= nodes && by + P <= nodes) {
    const float4* box = pot + (size_t)bx * nodes + by;
    float4 v[P * P];
#pragma unroll
    for (int a = 0; a < P; ++a)
#pragma unroll
      for (int b = 0; b < P; ++b) v[P * a + b] = __ldg(box + (size_t)a * nodes + b);
#pragma unroll
    for (int a = 0; a < P; ++a)
#pragma unroll
      for (int b = 0; b < P; ++b) add_tap(acc, v[P * a + b], __fmul_rn(wxi[a], wyi[b]));
  } else {
#pragma unroll
    for (int a = 0; a < P; ++a) {
      const int gx = bx + a;
      if (gx < 0 || gx >= nodes) continue;
#pragma unroll
      for (int b = 0; b < P; ++b) {
        const int gy = by + b;
        if (gy < 0 || gy >= nodes) continue;
        add_tap(acc, __ldg(pot + (size_t)gx * nodes + gy), __fmul_rn(wxi[a], wyi[b]));
      }
    }
  }
  phi[i] = acc;
}

}  // namespace

// pot [nodes, nodes, 4] fp32, base [n, 2] int32, wx / wy [n, 3] fp32 ->
// phi [n, 4] fp32; all row-major, pot and phi 16-byte aligned, base, wx
// and wy 4-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int fft_gather(const float* pot, const int32_t* base, const float* wx,
                          const float* wy, float* phi, int n, int nodes, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nodes <= 0 || (uintptr_t)pot % 16 || (uintptr_t)phi % 16 ||
      ((uintptr_t)base | (uintptr_t)wx | (uintptr_t)wy) % 4)
    return (int)cudaErrorInvalidValue;
  gather_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(pot), base, wx, wy,
      reinterpret_cast<float4*>(phi), n, nodes);
  return (int)cudaGetLastError();
}
