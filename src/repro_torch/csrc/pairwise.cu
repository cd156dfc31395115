// Pairwise squared distances, the KNN distance tile (paper §3.1).
//
// Replaces: src/repro/kernels/pairwise_kernel.py::_pairwise_kernel
//   (entry pairwise_sq_dists_pallas), which computes
//   out[i, j] = max(|q_i|^2 + |c_j|^2 - 2 q_i . c_j, 0) on the TPU's MXU.
//
// Bound on an H100: operations.  The tile does 2*Q*C*D operations on
// (Q + C)*D inputs; at the main path's shapes (D = 784)
// that is far above the card's balance point.  The |q|^2 + |c|^2 - 2qc
// form cancels, so the dot products need about fp32 accuracy: one TF32
// pass (11 significant bits) is not enough, but the 3xTF32 split is.
// Each fp32 value a becomes big = tf32(a) and small = tf32(a - big), and
// a.b ~ small.big + big.small + big.big (small.small, ~2^-22 relative,
// is dropped).  Three TF32 products at 495 TFLOP/s bound the tile:
// 6*Q*C*D operations, against 2*Q*C*D at 67 TFLOP/s on the CUDA cores.
//
// Design: mma.sync.m16n8k8 TF32 tensor-core tiles.
// - A block of 8 warps owns a 128 x 128 output tile, each warp 64 x 32
//   (4 x 4 mma tiles).  q [Q, D] and c [C, D] are both row-major, so both
//   operands are K-major, as the .row.col form wants.
// - D is staged in chunks of 32 floats through a 3-stage cp.async ring in
//   dynamic shared memory (opt-in above 48 KiB).  Rows are padded to 40
//   floats so that the float2 fragment reads are free of bank conflicts.
// - The mma's k index is permuted inside each group of 8: the lane that
//   holds logical k = t and t + 4 reads physical k = 2t and 2t + 1, for
//   both operands alike, so each fragment pair is one float2 read; the dot
//   product sums over the same k either way.
// - The tensor cores' fp32 accumulation does not round to nearest, so each
//   D-chunk is summed in a fresh fragment (small terms first) and added to
//   the running fp32 accumulator with ordinary FADDs.
// - Rows whose start is 16-byte aligned, with D a multiple of 4, stage
//   through 16-byte cp.async; any other input (a view at an odd offset,
//   D = 781) through 4-byte cp.async.  Both zero-fill past the ragged
//   edges of Q, C and D.
// - Epilogue: max(qn + cn - 2 acc, 0), fused, stored from the C fragments
//   as float2 where the row pitch allows it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // output rows (q) per block
constexpr int BN = 128;                 // output columns (c) per block
constexpr int BK = 32;                  // D chunk per pipeline stage
constexpr int STAGES = 3;
constexpr int LDS = BK + 8;             // padded shared row, floats
constexpr int WM = 64;                  // warp tile rows
constexpr int WN = 32;                  // warp tile columns
constexpr int MT = WM / 16;             // mma tiles per warp, rows
constexpr int NT = WN / 8;              // mma tiles per warp, columns
constexpr int THREADS = (BM / WM) * (BN / WN) * 32;   // 256
constexpr int STAGE_FLOATS = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);   // 122 880

static_assert(BM == BN, "load_operand stages BM rows of either operand");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The nearest TF32 value, ties away from zero: for finite x the bits of
// cvt.rna.tf32.f32, but in two integer operations, which issue at the
// full rate where the conversion unit does not.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = big + small to ~2^-22 relative; both exact TF32 values
__device__ __forceinline__ void split(float a, uint32_t& big, uint32_t& small) {
  big = to_tf32(a);
  small = to_tf32(a - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [row0, row0 + BM) x depth [k0, k0 + BK) of g [nrows, d] into
// s [BM][LDS], zero past nrows and d.  VEC: 16-byte copies (g and its row
// pitch 16-byte aligned); else 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void load_operand(float* s, const float* __restrict__ g,
                                             int row0, int nrows, int k0, int d,
                                             int tid) {
  if (VEC) {
#pragma unroll
    for (int r = 0; r < BM * BK / 4 / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / (BK / 4);
      const int k = (e % (BK / 4)) * 4;
      const bool ok = row0 + row < nrows && k0 + k < d;
      const float* src = ok ? g + (size_t)(row0 + row) * d + k0 + k : g;
      cp_async16(s + row * LDS + k, src, ok);
    }
  } else {
#pragma unroll
    for (int r = 0; r < BM * BK / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int row = e / BK;
      const int k = e % BK;
      const bool ok = row0 + row < nrows && k0 + k < d;
      const float* src = ok ? g + (size_t)(row0 + row) * d + k0 + k : g;
      cp_async4(s + row * LDS + k, src, ok);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
pairwise_kernel(const float* __restrict__ q, const float* __restrict__ c,
                const float* __restrict__ qn, const float* __restrict__ cn,
                float* __restrict__ out, int nq, int nc, int d) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // mma groupID
  const int t = lane & 3;                  // mma thread in group
  const int wm = (warp / (BN / WN)) * WM;  // warp's rows in the block tile
  const int wn = (warp % (BN / WN)) * WN;  // warp's columns
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nk = (d + BK - 1) / BK;

  auto load_stage = [&](int stage, int kt) {
    float* as = smem + stage * STAGE_FLOATS;
    load_operand<VEC>(as, q, row0, nq, kt * BK, d, tid);
    load_operand<VEC>(as + BM * LDS, c, col0, nc, kt * BK, d, tid);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // chunk kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and chunk kt-1 is consumed
    if (kt + STAGES - 1 < nk) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();

    const float* as = smem + (kt % STAGES) * STAGE_FLOATS;
    const float* bs = as + BM * LDS;
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.0f;

#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const int k = ks * 8 + 2 * t;        // physical k of logical t and t + 4
      uint32_t a_big[MT][4], a_small[MT][4], b_big[NT][2], b_small[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float2 lo = *reinterpret_cast<const float2*>(as + (wm + i * 16 + g) * LDS + k);
        const float2 hi =
            *reinterpret_cast<const float2*>(as + (wm + i * 16 + g + 8) * LDS + k);
        split(lo.x, a_big[i][0], a_small[i][0]);   // (row g,     k t)
        split(hi.x, a_big[i][1], a_small[i][1]);   // (row g + 8, k t)
        split(lo.y, a_big[i][2], a_small[i][2]);   // (row g,     k t + 4)
        split(hi.y, a_big[i][3], a_small[i][3]);   // (row g + 8, k t + 4)
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(bs + (wn + j * 8 + g) * LDS + k);
        split(v.x, b_big[j][0], b_small[j][0]);    // (k t,     column g)
        split(v.y, b_big[j][1], b_small[j][1]);    // (k t + 4, column g)
      }
      // small terms first; 16 independent tiles between dependent mmas
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], a_small[i], b_big[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], a_big[i], b_small[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], a_big[i], b_big[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }
  cp_async_wait<0>();   // no copy outlives the block (the tail groups are empty)

  // C fragment (i, j): rows g and g + 8, columns 2t and 2t + 1
  const bool pair_store = (nc % 2) == 0;   // row pitch keeps float2 aligned
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + i * 16 + g + 8 * h;
      if (r >= nq) continue;
      const float qr = qn[r];
      float* orow = out + (size_t)r * nc;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = col0 + wn + j * 8 + 2 * t;
        if (col >= nc) continue;
        const float v0 = fmaxf(qr + cn[col] - 2.0f * acc[i][j][2 * h], 0.0f);
        if (col + 1 < nc) {
          const float v1 = fmaxf(qr + cn[col + 1] - 2.0f * acc[i][j][2 * h + 1], 0.0f);
          if (pair_store) {
            *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
          } else {
            orow[col] = v0;
            orow[col + 1] = v1;
          }
        } else {
          orow[col] = v0;
        }
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* q, const float* c, const float* qn, const float* cn,
                   float* out, int nq, int nc, int d, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((nc + BN - 1) / BN, (nq + BM - 1) / BM);
  pairwise_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(q, c, qn, cn, out, nq,
                                                              nc, d);
  return cudaGetLastError();
}

}  // namespace

// out [nq, nc] = max(qn[:, None] + cn[None, :] - 2 q c^T, 0); all fp32,
// row-major and contiguous (q and c at any 4-byte-aligned address; out
// 8-byte aligned).  Returns cudaGetLastError() after the launch.
extern "C" int pairwise_sq_dists(const float* q, const float* c, const float* qn,
                                 const float* cn, float* out, int nq, int nc,
                                 int d, void* stream) {
  if (nq <= 0 || nc <= 0) return (int)cudaSuccess;
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? launch<true>(q, c, qn, cn, out, nq, nc, d, s)
                   : launch<false>(q, c, qn, cn, out, nq, nc, d, s));
}

// Dynamic shared memory a block of the kernel takes (bytes); ptxas -v
// reports only static shared memory.
extern "C" int pairwise_smem_bytes() { return SMEM_BYTES; }
