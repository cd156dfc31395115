// Barnes-Hut repulsion: the rope-linearised quadtree walk, paper §3.5.
//
// A two-lanes-a-point design of csrc/traverse.cu, kept for
// chip_variants.py's traverse set.  The same pack kernel and C entry; in
// the walk the two lanes of a pair load the two 16-byte halves of a
// node's record in one instruction (one 32-byte sector a point a step,
// where csrc/traverse.cu issues two loads of it) and swap them with four
// shuffles; both lanes then do the visit, and the even lane writes the
// point's results.  Twice the warps hide the chains, at twice the issued
// instructions.
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

__global__ void __launch_bounds__(THREADS)
traverse_walk_kernel(const float* __restrict__ y, const float* __restrict__ sum_y,
                     const Node* __restrict__ nodes, const int64_t* __restrict__ n_nodes,
                     float theta2, float* __restrict__ force, float* __restrict__ z_out,
                     int64_t* __restrict__ steps_out, int n, int cap) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int p = t >> 1;                            // two lanes a point
  const int half = t & 1;                          // the half of a record this lane loads
  if (p >= n) return;                              // both lanes of the pair
  const unsigned pair = 3u << (threadIdx.x & 30);
  const int nn = valid_nodes(n_nodes, cap);
  const int4* __restrict__ words = reinterpret_cast<const int4*>(nodes);
  const float yx = y[2 * p];
  const float yy = y[2 * p + 1];
  float fx = 0.0f, fy = 0.0f, z = 0.0f;
  int ptr = 0;
  int steps = 0;
  int4 mine = __ldg(words + half);
  while (ptr < nn) {
    if (steps == cap) __trap();
    int4 other;
    other.x = __shfl_xor_sync(pair, mine.x, 1);
    other.y = __shfl_xor_sync(pair, mine.y, 1);
    other.z = __shfl_xor_sync(pair, mine.z, 1);
    other.w = __shfl_xor_sync(pair, mine.w, 1);
    const int4 f = half ? other : mine;            // com_x, com_y, count, side^2 (bits)
    const int4 i = half ? mine : other;            // start, end, skip, 0
    float cnt = __int_as_float(f.z), cx = __int_as_float(f.x), cy = __int_as_float(f.y);
    if (i.x <= p && p < i.y) {                     // the node holds the point: take it out
      cnt = __fsub_rn(cnt, 1.0f);
      const float div = fmaxf(cnt, 1.0f);
      cx = __fdiv_rn(__fsub_rn(__ldg(sum_y + 2 * ptr), yx), div);
      cy = __fdiv_rn(__fsub_rn(__ldg(sum_y + 2 * ptr + 1), yy), div);
    }
    const float dx = __fsub_rn(yx, cx);
    const float dy = __fsub_rn(yy, cy);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    if (i.z != ptr + 1 && __int_as_float(f.w) >= __fmul_rn(theta2, d2)) {
      ptr = ptr + 1;                               // open: descend
    } else {
      const float q = __frcp_rn(__fadd_rn(d2, 1.0f));
      const float wq = __fmul_rn(cnt, q);
      z = __fadd_rn(z, wq);
      const float wqq = __fmul_rn(wq, q);
      fx = __fadd_rn(fx, __fmul_rn(wqq, dx));
      fy = __fadd_rn(fy, __fmul_rn(wqq, dy));
      ptr = i.z;                                   // accept: skip the subtree
    }
    ++steps;
    mine = __ldg(words + 2 * min(ptr, cap - 1) + half);
  }
  if (half == 0) {
    force[2 * p] = fx;
    force[2 * p + 1] = fy;
    z_out[p] = z;
    steps_out[p] = steps;
  }
}

unsigned blocks(int items, int threads) {
  return (unsigned)(((long long)items + threads - 1) / threads);
}

}  // namespace

// y_sorted [n, 2] fp32 in Morton order; the tree's start, end, skip [cap]
// int64 and n_nodes [] int64 (on the device); the summaries' count [cap],
// sum_y [cap, 2] and side [cap] fp32; theta2 = theta^2 in fp32; nodes, a
// scratch of cap 32-byte records, 16-byte aligned -> force [n, 2], z [n]
// fp32, steps [n] int64.  Returns the first cudaGetLastError() that is
// not cudaSuccess.
extern "C" int bh_traverse(const float* y_sorted, const int64_t* start, const int64_t* end,
                           const int64_t* skip, const int64_t* n_nodes, const float* count,
                           const float* sum_y, const float* side, float theta2, void* nodes,
                           float* force, float* z, int64_t* steps, int n, int cap,
                           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (cap <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Node* records = static_cast<Node*>(nodes);
  traverse_pack_kernel<<<blocks(cap, PACK_THREADS), PACK_THREADS, 0, s>>>(
      start, end, skip, n_nodes, count, sum_y, side, records, cap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  traverse_walk_kernel<<<blocks(2 * n, THREADS), THREADS, 0, s>>>(
      y_sorted, sum_y, records, n_nodes, theta2, force, z, steps, n, cap);
  return (int)cudaGetLastError();
}
