// Morton (Z-order) codes of the embedding, paper Algorithm 1.
//
// Replaces: src/repro/kernels/morton_kernel.py::_morton_kernel (entry
//   morton_encode_pallas): map each point into the root square, clip to
//   [0, 2^depth - 1], interleave 16 + 16 bits, mask to 2 * depth bits.
//
// Bound on an H100: bytes, and at the main path's size launch latency.  A
// point is 8 bytes in and 8 bytes out (the port carries codes as int64)
// for a dozen integer operations; 70 000 points move about 1.1 MB, which
// the card's memory moves in well under a microsecond, so the launch
// itself dominates.
//
// Design: one thread per point, the interleave in uint32 exactly as the
// TPU kernel does it, the code widened to int64 on the store.  Every
// thread computes the root cell from the bounding square's center and
// half-span, read on the device, as core/morton.py::root_params does:
// root = cent - r_span, scale = 2^(depth-1) / r_span, which PyTorch
// evaluates as reciprocal(r_span) * 2^(depth-1).  So the wrapper runs no
// tensor op but the output's allocation, and never syncs.  The float
// arithmetic is the plain version's, operation for operation (the _rn
// intrinsics keep nvcc from contracting into FMAs), so the codes are
// bit-identical.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t expand_bits(uint32_t v) {
  v &= 0x0000FFFFu;
  v = (v | (v << 8)) & 0x00FF00FFu;
  v = (v | (v << 4)) & 0x0F0F0F0Fu;
  v = (v | (v << 2)) & 0x33333333u;
  v = (v | (v << 1)) & 0x55555555u;
  return v;
}

__global__ void morton_kernel(const float* __restrict__ y,
                              const float* __restrict__ cent,
                              const float* __restrict__ r_span,
                              int64_t* __restrict__ codes, int n, int depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float r = __ldg(r_span);
  const float root_x = __fsub_rn(__ldg(cent), r);
  const float root_y = __fsub_rn(__ldg(cent + 1), r);
  const float scale = __fmul_rn(__frcp_rn(r), (float)(1u << (depth - 1)));
  const float hi = (float)((1u << depth) - 1u);
  const float mx_f = fminf(fmaxf(__fmul_rn(__fsub_rn(y[2 * i], root_x), scale), 0.0f), hi);
  const float my_f = fminf(fmaxf(__fmul_rn(__fsub_rn(y[2 * i + 1], root_y), scale), 0.0f), hi);
  uint32_t code = expand_bits((uint32_t)mx_f) | (expand_bits((uint32_t)my_f) << 1);
  if (depth < 16) code &= (1u << (2 * depth)) - 1u;
  codes[i] = (int64_t)code;
}

}  // namespace

// y [n, 2] fp32 row-major, cent [2] and r_span [] fp32 on the device ->
// codes [n] int64.  1 <= depth <= 16.  Returns cudaGetLastError().
extern "C" int morton_encode(const float* y, const float* cent, const float* r_span,
                             int64_t* codes, int n, int depth, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (depth < 1 || depth > 16) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  morton_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      y, cent, r_span, codes, n, depth);
  return (int)cudaGetLastError();
}
