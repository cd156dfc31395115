// Barnes-Hut repulsion: the rope-linearised quadtree walk, paper §3.5.
//
// The earlier design of csrc/traverse.cu, kept for chip_variants.py's
// traverse set, which times it beside the port's kernel: one thread a
// point over the tree's own int64 and fp32 arrays, seven scalar loads and
// two divisions a visit.  Same C entry as the port's, less the records.
//
// Replaces: src/repro/core/repulsive.py:55 (traverse, inside
//   bh_repulsion_sorted).  It has no pallas_call: the reference runs the
//   walk as a jax.vmap over a lax.while_loop, which XLA compiles into one
//   loop on the TPU.  Plain twin: repro_torch/core/repulsive.py::
//   bh_repulsion_sorted, a masked lockstep loop of whole-array ops.
//
// Each point walks the nodes in DFS pre-order: a node opens iff it is not
// a leaf (skip[k] == k + 1 marks a leaf) and side^2 >= theta^2 d^2, and
// then the walk steps to ptr + 1; otherwise the node's summary, with the
// point itself taken out of the node that holds it, adds cnt q to z and
// cnt q^2 (y - com) to the force, and the walk jumps to skip[k].
//
// Bound on an H100: the roofline bound is microseconds (a visit is ~25
// fp32 operations with three divisions; the node arrays are 40 bytes a
// node, read once from HBM).  What bounds the walk is latency: every step
// reads a node whose index the step before computed, so a thread runs a
// chain of dependent L1/L2 loads, hundreds of steps long.
//
// Design: one thread a point, the points in Morton order, so the lanes of
// a warp walk nearby paths and read the same nodes at about the same
// step; 256-thread CTAs (at a fitted embedding 2% faster than 128 and 7%
// than 64, within 1% of 128 at a random one: chip_variants.py --sets
// traverse); the node arrays through the read-only path (__ldg); no
// shared memory; n_nodes read on the device, so the caller never syncs.
// Every operation is written as __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn / __frcp_rn in the plain twin's order (d2 = dx*dx + dy*dy with the
// products rounded first; com = sum / max(cnt, 1); q = 1 / (1 + d2) as
// PyTorch's reciprocal; cnt*q, then *q, then *diff): that keeps nvcc from
// contracting into FMAs, so force, z and steps are bit-identical to the
// twin's.  The twin also adds an exact zero for an opened node; skipping
// that add changes no bit (the sums are never -0.0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

__global__ void __launch_bounds__(THREADS)
traverse_kernel(const float* __restrict__ y, const int64_t* __restrict__ start,
                const int64_t* __restrict__ end, const int64_t* __restrict__ skip,
                const int64_t* __restrict__ n_nodes_ptr, const float* __restrict__ count,
                const float* __restrict__ sum_y, const float* __restrict__ side,
                float theta2, float* __restrict__ force, float* __restrict__ z_out,
                int64_t* __restrict__ steps_out, int n, int cap) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int64_t n_nodes = ld(n_nodes_ptr);
  const float yx = y[2 * p];
  const float yy = y[2 * p + 1];
  float fx = 0.0f, fy = 0.0f, z = 0.0f;
  int64_t ptr = 0;
  int64_t steps = 0;
  while (ptr < n_nodes) {
    // ptr grows every step, so a well-formed tree ends the walk within
    // n_nodes <= cap steps: a longer walk is a malformed tree, and the
    // kernel fails rather than hang
    if (steps == cap) __trap();
    const int k = (int)(ptr < cap - 1 ? ptr : cap - 1);
    const bool inside = ld(start + k) <= p && p < ld(end + k);
    const float cnt = __fsub_rn(__ldg(count + k), inside ? 1.0f : 0.0f);
    const float sx = __fsub_rn(__ldg(sum_y + 2 * k), inside ? yx : 0.0f);
    const float sy = __fsub_rn(__ldg(sum_y + 2 * k + 1), inside ? yy : 0.0f);
    const float div = fmaxf(cnt, 1.0f);
    const float dx = __fsub_rn(yx, __fdiv_rn(sx, div));
    const float dy = __fsub_rn(yy, __fdiv_rn(sy, div));
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const int64_t next = ld(skip + k);
    const float s = __ldg(side + k);
    if (next != k + 1 && __fmul_rn(s, s) >= __fmul_rn(theta2, d2)) {
      ptr = ptr + 1;                               // open: descend
    } else {
      const float q = __frcp_rn(__fadd_rn(d2, 1.0f));
      const float wq = __fmul_rn(cnt, q);
      z = __fadd_rn(z, wq);
      const float wqq = __fmul_rn(wq, q);
      fx = __fadd_rn(fx, __fmul_rn(wqq, dx));
      fy = __fadd_rn(fy, __fmul_rn(wqq, dy));
      ptr = next;                                  // accept: skip the subtree
    }
    ++steps;
  }
  force[2 * p] = fx;
  force[2 * p + 1] = fy;
  z_out[p] = z;
  steps_out[p] = steps;
}

}  // namespace

// y_sorted [n, 2] fp32 in Morton order; the tree's start, end, skip [cap]
// int64 and n_nodes [] int64 (on the device); the summaries' count [cap],
// sum_y [cap, 2] and side [cap] fp32; theta2 = theta^2 in fp32 ->
// force [n, 2], z [n] fp32, steps [n] int64.  Returns cudaGetLastError().
extern "C" int bh_traverse(const float* y_sorted, const int64_t* start, const int64_t* end,
                           const int64_t* skip, const int64_t* n_nodes, const float* count,
                           const float* sum_y, const float* side, float theta2, float* force,
                           float* z, int64_t* steps, int n, int cap, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  traverse_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      y_sorted, start, end, skip, n_nodes, count, sum_y, side, theta2, force, z, steps, n,
      cap);
  return (int)cudaGetLastError();
}
