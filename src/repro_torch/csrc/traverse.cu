// Barnes-Hut repulsion: the rope-linearised quadtree walk, paper §3.5.
//
// Replaces: src/repro/core/repulsive.py:55 (traverse, inside
//   bh_repulsion_sorted).  It has no pallas_call: the reference runs the
//   walk as a jax.vmap over a lax.while_loop, which XLA compiles into one
//   loop on the TPU.  Plain twin: repro_torch/core/repulsive.py::
//   bh_repulsion_sorted, a masked lockstep loop of whole-array ops;
//   pack_nodes there is the plain twin of the first kernel below.
//
// Each point walks the nodes in DFS pre-order: a node opens iff it is not
// a leaf (skip[k] == k + 1 marks a leaf) and side^2 >= theta^2 d^2, and
// then the walk steps to ptr + 1; otherwise the node's summary, with the
// point itself taken out of the node that holds it, adds cnt q to z and
// cnt q^2 (y - com) to the force, and the walk jumps to skip[k].
//
// Bound on an H100: the roofline bound is microseconds (a visit is ~15
// fp32 operations; the node arrays are 40 bytes a node, read once from
// HBM).  What bounds the walk is latency: every step reads a node whose
// index the step before computed (~285 steps a point at the fitted
// MNIST-size embedding), the 32 lanes of a warp read 32 different nodes,
// so a step's gather waits for the slowest lane's record, and 70 000
// points give only ~17 warps an SM to hide the chains behind.
//
// Design, one call = two kernels on the caller's stream:
// 1. pack_kernel, one thread a valid node (n_nodes read on the device, so
//    the caller never syncs), writes a 32-byte record a node, one sector:
//    float4 {com_x, com_y, count, side^2} and int4 {start, end, skip, 0},
//    the indices narrowed to int32 (the wrapper refuses a capacity of
//    2^31).  com = sum / max(count, 1) and side * side are the rounded
//    operations the walk does for every node that does not hold the
//    point, so they are done once a node instead of once a visit; sum_y
//    stays in its own array, read only for a node whose range holds the
//    point (at most depth + 1 a walk).  At most 2N + 1 records, 4.5 MB
//    at N = 70 000: they stay in L2.
// 2. walk_kernel, one thread a point in Morton order (the lanes of a warp
//    walk nearby paths), 256 threads a CTA: a visit is two 16-byte loads
//    of one sector instead of seven scalar loads from six arrays, no
//    division but where the node holds the point, and the next record is
//    asked for as soon as its index is known.  Given pos (the sharded
//    gradient: one shard's points, the tree built over all of them),
//    thread i walks the point at sorted position pos[i] and writes row i;
//    the caller sorts pos ascending, so a warp's lanes still walk
//    Morton-neighbouring points.  Each point's walk is the same operations
//    either way, so its force, z and steps are the same bits.  The walk
//    is a template on pos: without it the kernel is the one-array walk.
// Measured on an H100 (chip_variants.py --sets traverse, PERF.md): at the
// fitted embedding the walk is ~1.7x faster than one over the tree's own
// arrays (variants/traverse_arrays.cu).  Slower, and not kept: a warp
// that steps through the union of its lanes' walks with uniform loads
// (variants/traverse_warp.cu: the union is ~1.6x the longest lane's walk,
// and every step waits on a warp vote), loading the record of ptr + 1
// ahead (one more gather a step), the first 512 records in shared memory,
// and CTAs of 64, 128 or 512 threads (1-12% slower at the fitted
// embedding, 128 2% faster at a random one); one CTA an SM is no faster.
// Every operation is written as __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn / __frcp_rn in the plain twin's order (d2 = dx*dx + dy*dy
// with the products rounded first; com = sum / max(cnt, 1); q = 1 /
// (1 + d2) as PyTorch's reciprocal; cnt*q, then *q, then *diff): that
// keeps nvcc from contracting into FMAs, so force, z and steps are
// bit-identical to the twin's.  For a node that does not hold the point
// the twin subtracts an exact zero from count and sum (x - 0 == x, -0.0
// included), so the packed com is its com.  The twin also adds an exact
// zero for an opened node; skipping that add changes no bit (the sums are
// never -0.0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // a CTA of the walk
constexpr int PACK_THREADS = 256;  // a CTA of the pack

// A node's hot record: one 32-byte sector, read as two 16-byte loads.
struct __align__(16) Node {
  float4 f;  // com_x, com_y, count, side^2
  int4 i;    // start, end, skip, 0
};

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// n_nodes, read on the device; a count outside [0, cap] is a malformed
// tree, and the kernel fails rather than read past the arrays
__device__ __forceinline__ int valid_nodes(const int64_t* n_nodes, int cap) {
  const int64_t nn = ld(n_nodes);
  if (nn < 0 || nn > cap) __trap();
  return (int)nn;
}

__global__ void __launch_bounds__(PACK_THREADS)
traverse_pack_kernel(const int64_t* __restrict__ start, const int64_t* __restrict__ end,
                     const int64_t* __restrict__ skip, const int64_t* __restrict__ n_nodes,
                     const float* __restrict__ count, const float* __restrict__ sum_y,
                     const float* __restrict__ side, Node* __restrict__ nodes, int cap) {
  const int k = blockIdx.x * PACK_THREADS + threadIdx.x;
  if (k >= cap || k >= valid_nodes(n_nodes, cap)) return;
  const float cnt = count[k];
  const float div = fmaxf(cnt, 1.0f);
  const float s = side[k];
  Node r;
  r.f = make_float4(__fdiv_rn(sum_y[2 * k], div), __fdiv_rn(sum_y[2 * k + 1], div), cnt,
                    __fmul_rn(s, s));
  r.i = make_int4((int)start[k], (int)end[k], (int)skip[k], 0);
  nodes[k] = r;
}

__device__ __forceinline__ Node load_node(const Node* __restrict__ nodes, int k) {
  Node r;
  r.f = __ldg(&nodes[k].f);
  r.i = __ldg(&nodes[k].i);
  return r;
}

template <bool kPos>
__global__ void __launch_bounds__(THREADS)
traverse_walk_kernel(const float* __restrict__ y, const float* __restrict__ sum_y,
                     const Node* __restrict__ nodes, const int64_t* __restrict__ n_nodes,
                     const int32_t* __restrict__ pos, float theta2,
                     float* __restrict__ force, float* __restrict__ z_out,
                     int64_t* __restrict__ steps_out, int n, int n_points, int cap) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  int p = i;
  if (kPos) {
    p = __ldg(pos + i);
    if (p < 0 || p >= n_points) __trap();        // a position off the points
  }
  const int nn = valid_nodes(n_nodes, cap);
  const float yx = y[2 * p];
  const float yy = y[2 * p + 1];
  float fx = 0.0f, fy = 0.0f, z = 0.0f;
  int ptr = 0;
  int steps = 0;
  Node r = load_node(nodes, 0);
  while (ptr < nn) {
    // ptr grows every step, so a well-formed tree ends the walk within
    // nn <= cap steps: a longer walk is a malformed tree, and the kernel
    // fails rather than hang
    if (steps == cap) __trap();
    float cnt = r.f.z, cx = r.f.x, cy = r.f.y;
    if (r.i.x <= p && p < r.i.y) {                 // the node holds the point: take it out
      cnt = __fsub_rn(cnt, 1.0f);
      const float div = fmaxf(cnt, 1.0f);
      cx = __fdiv_rn(__fsub_rn(__ldg(sum_y + 2 * ptr), yx), div);
      cy = __fdiv_rn(__fsub_rn(__ldg(sum_y + 2 * ptr + 1), yy), div);
    }
    const float dx = __fsub_rn(yx, cx);
    const float dy = __fsub_rn(yy, cy);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    if (r.i.z != ptr + 1 && r.f.w >= __fmul_rn(theta2, d2)) {
      ptr = ptr + 1;                               // open: descend
    } else {
      const float q = __frcp_rn(__fadd_rn(d2, 1.0f));
      const float wq = __fmul_rn(cnt, q);
      z = __fadd_rn(z, wq);
      const float wqq = __fmul_rn(wq, q);
      fx = __fadd_rn(fx, __fmul_rn(wqq, dx));
      fy = __fadd_rn(fy, __fmul_rn(wqq, dy));
      ptr = r.i.z;                                 // accept: skip the subtree
    }
    ++steps;
    r = load_node(nodes, min(ptr, cap - 1));       // the next record, asked for at once
  }
  force[2 * i] = fx;
  force[2 * i + 1] = fy;
  z_out[i] = z;
  steps_out[i] = steps;
}

unsigned blocks(int items, int threads) {
  return (unsigned)(((long long)items + threads - 1) / threads);
}

}  // namespace

// y_sorted [n_points, 2] fp32 in Morton order; the tree's start, end,
// skip [cap] int64 and n_nodes [] int64 (on the device); the summaries'
// count [cap], sum_y [cap, 2] and side [cap] fp32; theta2 = theta^2 in
// fp32; nodes, a scratch of cap 32-byte records, 16-byte aligned; pos
// [n] int32 sorted positions in [0, n_points), or null (n = n_points, row
// i is position i) -> force [n, 2], z [n] fp32, steps [n] int64.  Returns
// the first cudaGetLastError() that is not cudaSuccess.
extern "C" int bh_traverse(const float* y_sorted, const int64_t* start, const int64_t* end,
                           const int64_t* skip, const int64_t* n_nodes, const float* count,
                           const float* sum_y, const float* side, float theta2, void* nodes,
                           const int32_t* pos, float* force, float* z, int64_t* steps, int n,
                           int n_points, int cap, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (cap <= 0 || (pos == nullptr && n != n_points)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Node* records = static_cast<Node*>(nodes);
  traverse_pack_kernel<<<blocks(cap, PACK_THREADS), PACK_THREADS, 0, s>>>(
      start, end, skip, n_nodes, count, sum_y, side, records, cap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (pos == nullptr) {
    traverse_walk_kernel<false><<<blocks(n, THREADS), THREADS, 0, s>>>(
        y_sorted, sum_y, records, n_nodes, nullptr, theta2, force, z, steps, n, n_points, cap);
  } else {
    traverse_walk_kernel<true><<<blocks(n, THREADS), THREADS, 0, s>>>(
        y_sorted, sum_y, records, n_nodes, pos, theta2, force, z, steps, n, n_points, cap);
  }
  return (int)cudaGetLastError();
}
