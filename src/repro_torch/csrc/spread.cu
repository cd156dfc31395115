// FFT-repulsion spread: scatter per-point charges onto the node lattice
// through the separable 3x3 Lagrange stencil.
//
// Replaces: src/repro/kernels/interp_kernel.py::_spread_kernel (entry
//   spread_to_grid_pallas):
//     grid[a, b, c] += wx[i, a - bx_i] * wy[i, b - by_i] * ch[i, c]
//   for the 9 taps (a, b) of each point i.  The TPU has no scatter, so the
//   Pallas kernel builds one-hot [TILE, G] tap matrices and multiplies them
//   on the MXU; its grid walks the point tiles in order and adds each
//   tile's lattice into one resident output block.
//
// Bound on an H100: bytes.  A point reads 44 bytes (2 int32 base, 6
// weights, 3 charges) and the [nodes, nodes, C] grid is written once:
// 70 000 points and 97 x 97 x 3 nodes move about 3.2 MB, about 1 us of
// memory time.  At that size the launch latency (a few us) is the floor.
//
// Design: one kernel for every lattice size, no atomics, bit-reproducible.
// * Ownership by lattice rows.  The lattice's rows are cut into bands of
//   `rows` rows (blockIdx.y) and the points' index range into `slices`
//   contiguous slices (blockIdx.x).  The CTA (band, slice) owns one band and
//   one slice; the slices' CTAs of a band form one thread-block cluster
//   (at most 8, the portable size).  A band is a few KiB, so each warp keeps
//   a private copy of it in shared memory, at every lattice size up to
//   MAX_N_BOXES = 128 (257 nodes).
// * Scan, then update in index order.  The CTA walks its slice in segments
//   of warps x SCAN x 32 points.  Scan: each warp loads the base rows of its
//   SCAN batches of the segment at once (the next segment's loads are in
//   flight while this one is added), ballots the points whose x-taps
//   bx..bx+2 meet the band, and writes their indices into the segment's hit
//   list in index order.  Update: the warps cut the hit list into
//   contiguous equal shares, so a dense band's work is spread evenly.  A
//   warp takes its share 32 hits at a time (the next 32 hits' loads in
//   flight): each lane loads its point and writes a tap record to shared
//   memory -- the point's offset in the band, a 9-bit mask of its taps on
//   the band, and the 9c products (wx[a] * wy[b]) * ch[k], the plain
//   version's, rounded as it rounds them.  Then, point after point in index
//   order, lane t adds tap t of the record into the warp's copy (a tap off
//   the band goes to a dummy word).  The lanes of one point write distinct
//   addresses, so nothing conflicts; the row stride of a copy is padded so
//   that a point's 27 addresses fall in 27 distinct banks, and the next
//   point's record is read before this point's add, so that a point costs
//   one shared load, add and store.
// * Fixed-order reduction.  The CTA sums its warps' copies in warp order;
//   after cluster.sync() each rank sums its share of the band over the
//   cluster's ranks in rank order through distributed shared memory, and
//   writes it with plain coalesced stores; a second cluster barrier keeps
//   every CTA's shared memory alive until all its readers are done.  Every
//   node is written exactly once: the caller passes an uninitialised grid,
//   and there is no memset and no global atomic.
// The Pallas kernel's sequential grid accumulates the point tiles in
// index order into one resident lattice.  Here each warp adds contiguous
// runs of points in index order, the warps' copies are summed in warp
// order and the ranks in rank order: every node's sum runs over its points
// in an order fixed by the inputs' shapes and values alone, so the grid is
// bit-identical from run to run.  It is held to the plain version with a
// relative tolerance (another order of the same sum), and is exact on
// lattice-node points with integer charges.
//
// Taps outside the lattice are skipped.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int P = 3;             // Lagrange nodes per box per dim
constexpr int SCAN = 8;          // batches of 32 points a warp scans a segment
constexpr int CH_REGS = 4;       // charges a point keeps in registers (more: read in place)
constexpr int MAX_SLICES = 8;    // portable cluster size
constexpr int MAX_WARPS = 16;
constexpr int SHARED_48K = 48 * 1024;

// Words of one band row: nodes * c, padded to 3c (mod 32) so that the taps
// of rows a = 0, 1, 2 of a point start 3c banks apart.
__host__ __device__ inline int row_stride(int nodes, int c) {
  const int words = nodes * c;
  return words + (((3 * c - words) % 32) + 32) % 32;
}

// Words of a tap record (offset, mask, 9c products); odd, so that 32 lanes
// writing 32 records hit 32 distinct banks.
__host__ __device__ inline int tap_words(int c) { return (P * P * c + 2) | 1; }

// Shared memory of a CTA: per warp a band copy, its dummy word and 32 tap
// records; the segment's hit list and the warps' hit counts.
__host__ __device__ inline size_t smem_bytes(int nodes, int c, int rows, int warps) {
  return sizeof(float) * (size_t)warps *
         ((size_t)rows * row_stride(nodes, c) + 1 + 32 * tap_words(c) + SCAN * 32 + 1);
}

// The cluster barrier without the release fence of cluster.sync(): for the
// last barrier, whose only job is to keep the shared memory alive until
// the other ranks have read it (their loads have returned by then).
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ int round32(int a) { return (a + 31) & ~31; }

// A point's index, base, weights and first CH_REGS charges.
struct Point {
  int i;
  int2 b;
  float wx[P], wy[P], ch[CH_REGS];
};

__device__ __forceinline__ void load_point(Point& pt, bool valid, int i,
                                           const int2* __restrict__ base,
                                           const float* __restrict__ wx,
                                           const float* __restrict__ wy,
                                           const float* __restrict__ ch, int c) {
  if (!valid) return;
  pt.i = i;
  pt.b = __ldg(base + i);
#pragma unroll
  for (int t = 0; t < P; ++t) {
    pt.wx[t] = __ldg(wx + (size_t)P * i + t);
    pt.wy[t] = __ldg(wy + (size_t)P * i + t);
  }
#pragma unroll
  for (int k = 0; k < CH_REGS; ++k)
    if (k < c) pt.ch[k] = __ldg(ch + (size_t)i * c + k);
}

// Base rows bx of a warp's SCAN batches from point i0 + lane on; a point at
// or past `hi` gets a row that meets no band.
__device__ __forceinline__ void load_scan(int (&bx)[SCAN], const int32_t* __restrict__ base,
                                          int i0, int hi) {
#pragma unroll
  for (int v = 0; v < SCAN; ++v) {
    const int i = i0 + v * 32;
    bx[v] = i < hi ? __ldg(base + 2 * (size_t)i) : INT32_MIN;
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
spread_kernel(const int32_t* __restrict__ base, const float* __restrict__ wx,
              const float* __restrict__ wy, const float* __restrict__ ch,
              float* __restrict__ grid, int n, int nodes, int c, int rows) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = row_stride(nodes, c);
  const int tw = tap_words(c);
  const int copy_words = rows * stride + 1;          // the band and a dummy word
  float* copies = smem;
  float* copy = copies + warp * copy_words;
  float* dummy = copy + copy_words - 1;
  float* recs = copies + warps * copy_words + warp * 32 * tw;
  int* list = reinterpret_cast<int*>(copies + warps * (copy_words + 32 * tw));
  int* counts = list + warps * SCAN * 32;

  const int slices = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * rows;
  const int band_rows = min(rows, nodes - row0);

  for (int j = lane; j < copy_words; j += 32) copy[j] = 0.0f;

  // lane t's tap t = (a, b, k) of a point's 9c (more than 32 taps: c > 3,
  // the lanes take the rest in further passes); bit 31 of a mask is never set
  const int taps = P * P * c;
  const int a0 = lane / (P * c), b0 = (lane / c) % P, k0 = lane % c;
  const int bit0 = lane < taps ? a0 * P + b0 : 31;
  const int toff0 = a0 * stride + b0 * c + k0;

  // the slice of this rank, in segments of seg points
  const int slice_len = round32(ceil_div(n, slices));
  const int s_lo = min(n, rank * slice_len);
  const int s_hi = min(n, s_lo + slice_len);
  const int seg = warps * SCAN * 32;
  const int2* base2 = reinterpret_cast<const int2*>(base);
  int scan[SCAN];
  load_scan(scan, base, s_lo + warp * SCAN * 32 + lane, s_hi);

  for (int seg0 = s_lo; seg0 < s_hi; seg0 += seg) {
    // scan: this warp's batches, hits into the list in index order
    unsigned hits[SCAN];
    int count = 0;
#pragma unroll
    for (int v = 0; v < SCAN; ++v) {
      hits[v] = __ballot_sync(0xffffffffu, scan[v] >= row0 - (P - 1) &&
                                               scan[v] < row0 + band_rows);
      count += __popc(hits[v]);
    }
    if (lane == 0) counts[warp] = count;
    __syncthreads();
    int pos = 0, total = 0;
    for (int w = 0; w < warps; ++w) {
      const int cw = counts[w];
      pos += w < warp ? cw : 0;
      total += cw;
    }
    const int w0 = seg0 + warp * SCAN * 32;
#pragma unroll
    for (int v = 0; v < SCAN; ++v) {
      if ((hits[v] >> lane) & 1u)
        list[pos + __popc(hits[v] & ((1u << lane) - 1u))] = w0 + v * 32 + lane;
      pos += __popc(hits[v]);
    }
    load_scan(scan, base, w0 + seg + lane, s_hi);
    __syncthreads();

    // update: this warp's contiguous share of the segment's hits
    const int share = ceil_div(total, warps);
    const int h0 = min(total, warp * share);
    const int h1 = min(total, h0 + share);
    Point cur, nxt;
    load_point(cur, h0 + lane < h1, h0 + lane < h1 ? list[h0 + lane] : 0, base2, wx, wy, ch,
               c);
    for (int hb = h0; hb < h1; hb += 32) {
      const int hn = hb + 32 + lane;
      load_point(nxt, hn < h1, hn < h1 ? list[hn] : 0, base2, wx, wy, ch, c);
      const int live = min(32, h1 - hb);
      if (lane < live) {           // this lane's point: its tap record
        float* q = recs + lane * tw;
        const int bx = cur.b.x - row0, by = cur.b.y;
        unsigned mask = 0;
#pragma unroll
        for (int a = 0; a < P; ++a) {
#pragma unroll
          for (int b = 0; b < P; ++b) {
            const bool on = bx + a >= 0 && bx + a < band_rows && by + b >= 0 && by + b < nodes;
            mask |= (unsigned)on << (a * P + b);
            const float w = __fmul_rn(cur.wx[a], cur.wy[b]);
            float* qab = q + 2 + (a * P + b) * c;
#pragma unroll
            for (int k = 0; k < CH_REGS; ++k)
              if (k < c) qab[k] = __fmul_rn(w, cur.ch[k]);
            for (int k = CH_REGS; k < c; ++k)
              qab[k] = __fmul_rn(w, __ldg(ch + (size_t)cur.i * c + k));
          }
        }
        q[0] = __int_as_float(bx * stride + by * c);
        q[1] = __uint_as_float(mask);
      }
      __syncwarp();
      // the points in index order; the next record is read before this add
      const float* q = recs;
      int off = __float_as_int(q[0]);
      unsigned mask = __float_as_uint(q[1]);
      float p = lane < taps ? q[2 + lane] : 0.0f;
      for (int j = 0; j < live; ++j) {
        const float* qn = recs + min(j + 1, live - 1) * tw;
        const int off_n = __float_as_int(qn[0]);
        const unsigned mask_n = __float_as_uint(qn[1]);
        const float p_n = lane < taps ? qn[2 + lane] : 0.0f;
        float* node = (mask >> bit0) & 1u ? copy + off + toff0 : dummy;
        *node = __fadd_rn(*node, p);
        for (int t = lane + 32; t < taps; t += 32) {
          const int a = t / (P * c), b = (t / c) % P;
          if ((mask >> (a * P + b)) & 1u) {
            float* nd = copy + off + a * stride + b * c + t % c;
            *nd = __fadd_rn(*nd, q[2 + t]);
          }
        }
        __syncwarp();              // the next point may add into the same nodes
        q = qn;
        off = off_n;
        mask = mask_n;
        p = p_n;
      }
      cur = nxt;
    }
    __syncthreads();               // the list and counts are rewritten next segment
  }

  // the CTA's warps in warp order, into warp 0's copy
  __syncthreads();
  const int row_words = nodes * c;
  const int band_words = band_rows * row_words;
  for (int j = threadIdx.x; j < band_words; j += blockDim.x) {
    const int off = (j / row_words) * stride + j % row_words;
    float s = copies[off];
    for (int w = 1; w < warps; ++w) s = __fadd_rn(s, copies[w * copy_words + off]);
    copies[off] = s;
  }
  cluster.sync();
  // this rank's share of the band, summed over the ranks in rank order
  const int part = ceil_div(band_words, slices);
  const int j_lo = rank * part;
  const int j_hi = min(band_words, j_lo + part);
  float* out = grid + (size_t)row0 * row_words;
  for (int j = j_lo + threadIdx.x; j < j_hi; j += blockDim.x) {
    float* own = copies + (j / row_words) * stride + j % row_words;
    float v[MAX_SLICES];           // all ranks' loads in flight, then the sum in order
#pragma unroll
    for (int q = 0; q < MAX_SLICES; ++q)
      if (q < slices) v[q] = *cluster.map_shared_rank(own, q);
    float s = v[0];
#pragma unroll
    for (int q = 1; q < MAX_SLICES; ++q)
      if (q < slices) s = __fadd_rn(s, v[q]);
    out[j] = s;
  }
  cluster_sync_relaxed();
}

}  // namespace

// Dynamic shared memory of one CTA for a plan (bytes); the Python plan
// computes the same number and passes it to fft_spread.
extern "C" long long fft_spread_smem_bytes(int nodes, int c, int rows, int warps) {
  return (long long)smem_bytes(nodes, c, rows, warps);
}

// base [n, 2] int32 (8-byte aligned), wx / wy [n, 3] fp32, charges [n, c]
// fp32 -> grid [nodes, nodes, c] fp32, all row-major; every node of the
// grid is written.  The launch plan: bands of `rows` lattice rows, `slices`
// CTAs a band (one cluster), `warps` warps a CTA, `smem` bytes of dynamic
// shared memory a CTA (must equal fft_spread_smem_bytes).
// Returns a cudaError_t (0 on success).
extern "C" int fft_spread(const int32_t* base, const float* wx, const float* wy,
                          const float* charges, float* grid, int n, int nodes, int c,
                          int rows, int slices, int warps, long long smem, void* stream) {
  if (n < 0 || nodes <= 0 || c <= 0 || rows <= 0 || slices < 1 || slices > MAX_SLICES ||
      warps < 1 || warps > MAX_WARPS || smem != (long long)smem_bytes(nodes, c, rows, warps))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (smem > SHARED_48K)
    err = cudaFuncSetAttribute(spread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, (nodes + rows - 1) / rows, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, spread_kernel, base, wx, wy, charges, grid, n, nodes, c,
                           rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
