// Exact K nearest points in the BEV plane for a list of query points, for
// every frame of a batch: ContFuse's neighbour search (ops/knn.py).
//
// Replaces no `pl.pallas_call`: the JAX package has no ContFuse. The plain
// twin (ops/knn.py `bev_knn_plain`) computes every distance and takes K
// rounds of argmin; at the served size (187,000 query points a frame over
// four BEV scales, 32,768 point slots) that is 6.1e9 distances a frame.
//
// Contract: the twin's indices, bit for bit.
// * A point j is a candidate of query i where valid[j] and
//   d2 = (px_j - qx_i)^2 + (pz_j - qz_i)^2 <= r2, each operation rounded
//   in f32 as the twin's separate tensor ops round it:
//     d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)),
//     dx = __fsub_rn(px, qx), dz = __fsub_rn(pz, qz)
//   (no fused multiply-add: `--fmad=false` and the intrinsics both say so).
// * The K candidates of least (d2, j), in that order, ties to the lower
//   point index; slots beyond a query's candidates hold P (the frame's
//   point slots), the twin's "no point".
//
// What bounds it. The output (B x Q x K int64) and the points are a few tens
// of MB; the work is the distances a query examines. A fixed grid of square
// bins over the BEV (side `bin`) holds each frame's valid points, sorted by
// bin (a counting sort, one block a frame). A query examines the bins in
// rings of growing Chebyshev radius r about its own bin and stops once the
// nearest any point of ring r can lie, (r - 1) x bin + the query's distance
// to its own bin's nearest edge, is beyond its K-th candidate's distance or
// beyond sqrt(r2). Where points are dense (near the sensor) a query reads
// its own bin and its eight neighbours; where they are sparse it reads more
// rings, each of few points. The order of points inside a bin is the
// atomics' and does not matter: the (d2, j) order decides.
//
// What the design does about it.
// * A row of a ring is one contiguous range of the sorted points (bins are
//   numbered row-major), so a ring is at most 2r + 1 ranges.
// * Neighbouring threads take neighbouring query points of one lattice, so
//   a warp's searches cover the same bins and mostly stop at the same ring.
// * K is fixed at 3, ContFuse's neighbours: the candidates stay in
//   registers, and a call of another K is refused.
// * The lower bound carries a margin of 1e-3 m against the rounding of the
//   bin edges: a ring is read whenever one of its points could still count.
// * Each block adds its queries and the distances they examined to two
//   device counters (one atomic each a block), read by `knn_counts()`.
#include "common.cuh"

namespace {

constexpr int kBinThreads = 1024;
constexpr int kQueryThreads = 256;
constexpr int kMaxBins = 10 * 1024;  // per frame: the counts live in 40 KB of shared memory
constexpr int kK = 3;  // the neighbours a query keeps
constexpr float kEdgeMargin = 1e-3f;  // m

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ __forceinline__ int bin_of(float v, float origin, float bin, int n) {
  return clampi((int)floorf((v - origin) / bin), 0, n - 1);
}

// One block a frame: count the valid points a bin, scan the counts into
// starts, place each point (x, z, index) at its bin's next free slot.
__global__ void __launch_bounds__(kBinThreads) knn_bin(const float* __restrict__ points, int P, int C,
                                                       const bool* __restrict__ valid, float x0, float z0, float bin,
                                                       int nbx, int nbz, float2* __restrict__ sorted_xz,
                                                       int* __restrict__ sorted_id, int* __restrict__ bin_start) {
  __shared__ int count[kMaxBins];
  __shared__ int warp_total[kBinThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, nbins = nbx * nbz;
  const float* pts = points + (size_t)b * P * C;
  const bool* ok = valid + (size_t)b * P;
  for (int i = tid; i < nbins; i += kBinThreads) count[i] = 0;
  __syncthreads();
  for (int j = tid; j < P; j += kBinThreads) {
    if (!ok[j]) continue;
    const int k = bin_of(pts[(size_t)j * C + 2], z0, bin, nbz) * nbx + bin_of(pts[(size_t)j * C], x0, bin, nbx);
    atomicAdd(&count[k], 1);
  }
  __syncthreads();
  // exclusive scan: a run of `per` bins a thread, then the threads' totals
  const int per = (nbins + kBinThreads - 1) / kBinThreads;
  const int lo = tid * per, hi = min(lo + per, nbins);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += count[i];
  int incl = own;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kBinThreads / 32 ? warp_total[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += v;
    }
    if (lane < kBinThreads / 32) warp_total[lane] = t;
  }
  __syncthreads();
  int run = incl - own + (warp > 0 ? warp_total[warp - 1] : 0);
  int* starts = bin_start + (size_t)b * (nbins + 1);
  for (int i = lo; i < hi; ++i) {
    const int c = count[i];
    starts[i] = run;
    count[i] = run;  // now the bin's cursor
    run += c;
  }
  if (tid == kBinThreads - 1) starts[nbins] = warp_total[kBinThreads / 32 - 1];
  __syncthreads();
  float2* xz = sorted_xz + (size_t)b * P;
  int* ids = sorted_id + (size_t)b * P;
  for (int j = tid; j < P; j += kBinThreads) {
    if (!ok[j]) continue;
    const float px = pts[(size_t)j * C], pz = pts[(size_t)j * C + 2];
    const int k = bin_of(pz, z0, bin, nbz) * nbx + bin_of(px, x0, bin, nbx);
    const int slot = atomicAdd(&count[k], 1);
    xz[slot] = make_float2(px, pz);
    ids[slot] = j;
  }
}

struct Best {
  float d[kK];
  int i[kK];
  __device__ __forceinline__ void init(int none) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      d[k] = __int_as_float(0x7f800000);  // +inf
      i[k] = none;
    }
  }
  // (d2, j) joins where it orders before the K-th; the list stays sorted
  __device__ __forceinline__ void offer(float d2, int j) {
    if (!(d2 < d[kK - 1] || (d2 == d[kK - 1] && j < i[kK - 1]))) return;
    d[kK - 1] = d2;
    i[kK - 1] = j;
#pragma unroll
    for (int k = kK - 1; k > 0; --k) {
      const bool before = d[k] < d[k - 1] || (d[k] == d[k - 1] && i[k] < i[k - 1]);
      if (before) {
        const float td = d[k];
        d[k] = d[k - 1];
        d[k - 1] = td;
        const int ti = i[k];
        i[k] = i[k - 1];
        i[k - 1] = ti;
      }
    }
  }
};

__global__ void __launch_bounds__(kQueryThreads) knn_query(
    const float2* __restrict__ queries, int Q, int P, float x0, float z0, float bin, int nbx, int nbz, float r2,
    float max_d, int rings, const float2* __restrict__ sorted_xz, const int* __restrict__ sorted_id,
    const int* __restrict__ bin_start, long long* __restrict__ out, unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long warp_sums[kQueryThreads / 32][2];
  const int b = blockIdx.y, q = blockIdx.x * kQueryThreads + threadIdx.x;
  const int nbins = nbx * nbz;
  const float2* xz = sorted_xz + (size_t)b * P;
  const int* ids = sorted_id + (size_t)b * P;
  const int* starts = bin_start + (size_t)b * (nbins + 1);
  unsigned long long examined = 0;
  if (q < Q) {
    const float2 qp = queries[q];
    const int bx = bin_of(qp.x, x0, bin, nbx), bz = bin_of(qp.y, z0, bin, nbz);
    const float ex = fminf(qp.x - (x0 + bx * bin), x0 + (bx + 1) * bin - qp.x);
    const float ez = fminf(qp.y - (z0 + bz * bin), z0 + (bz + 1) * bin - qp.y);
    const float edge = fmaxf(fminf(ex, ez), 0.0f);
    Best best;
    best.init(P);
    for (int r = 0; r <= rings; ++r) {
      if (r > 0) {
        const float lb = (r - 1) * bin + edge - kEdgeMargin;
        if (lb > max_d) break;
        if (lb > 0.0f && lb * lb > best.d[kK - 1]) break;
      }
      for (int dz = -r; dz <= r; ++dz) {
        const int z = bz + dz;
        if (z < 0 || z >= nbz) continue;
        const bool full = dz == -r || dz == r;
        // a full row of the ring, or its two ends
        for (int part = 0; part < (full ? 1 : 2); ++part) {
          int xlo, xhi;
          if (full) {
            xlo = max(bx - r, 0);
            xhi = min(bx + r, nbx - 1);
          } else {
            xlo = xhi = part == 0 ? bx - r : bx + r;
            if (xlo < 0 || xlo >= nbx) continue;
          }
          const int s = starts[z * nbx + xlo], e = starts[z * nbx + xhi + 1];
          examined += (unsigned long long)(e - s);
          for (int t = s; t < e; ++t) {
            const float2 p = xz[t];
            const float dx = __fsub_rn(p.x, qp.x), dzv = __fsub_rn(p.y, qp.y);
            const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dzv, dzv));
            if (d2 <= r2) best.offer(d2, ids[t]);
          }
        }
      }
    }
    long long* o = out + ((size_t)b * Q + q) * kK;
#pragma unroll
    for (int k = 0; k < kK; ++k) o[k] = best.i[k];
  }
  // the block's queries and examined distances: one atomic each
  unsigned long long nq = q < Q ? 1ull : 0ull;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    examined += __shfl_down_sync(0xffffffffu, examined, d);
    nq += __shfl_down_sync(0xffffffffu, nq, d);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_sums[warp][0] = nq;
    warp_sums[warp][1] = examined;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long a = 0, e = 0;
#pragma unroll
    for (int w = 0; w < kQueryThreads / 32; ++w) {
      a += warp_sums[w][0];
      e += warp_sums[w][1];
    }
    atomicAdd(counts, a);
    atomicAdd(counts + 1, e);
  }
}

}  // namespace

// The most bins a frame and the one K the kernel takes.
extern "C" int bev_knn_max_bins() { return kMaxBins; }
extern "C" int bev_knn_k() { return kK; }

// points: [B, P, C] f32 (x at 0, z at 2), valid: [B, P] bool, queries: [Q, 2]
// f32 (x, z); the bins: nbx x nbz squares of side `bin` from (x0, z0);
// r2: the largest squared distance kept (finite), max_d its root;
// scratch: sorted_xz [B, P] float2, sorted_id [B, P] int, bin_start
// [B, nbx * nbz + 1] int; out: [B, Q, 3] int64; counts: 2 uint64 the
// kernel adds the queries and the distances examined to.
extern "C" int bev_knn_launch(const float* points, int B, int P, int C, const bool* valid, const float* queries,
                              int Q, int K, float x0, float z0, float bin, int nbx, int nbz, float r2, float max_d,
                              void* sorted_xz, int* sorted_id, int* bin_start, long long* out, void* counts,
                              void* stream) {
  if (B < 1 || P < 1 || Q < 1 || C < 3 || K != kK || nbx < 1 || nbz < 1 || nbx * nbz > kMaxBins ||
      !(bin > 0.0f) || !isfinite(max_d) || !spt::aligned(queries, 8) || !spt::aligned(sorted_xz, 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* xz = static_cast<float2*>(sorted_xz);
  knn_bin<<<(unsigned)B, kBinThreads, 0, s>>>(points, P, C, valid, x0, z0, bin, nbx, nbz, xz, sorted_id, bin_start);
  // every bin lies within max(nbx, nbz) rings; beyond ceil(max_d / bin) + 1 every ring lies past max_d
  const int rings = min(max(nbx, nbz), (int)ceilf(max_d / bin) + 1);
  const dim3 grid((unsigned)((Q + kQueryThreads - 1) / kQueryThreads), (unsigned)B);
  const float2* qs = reinterpret_cast<const float2*>(queries);
  auto* cnt = static_cast<unsigned long long*>(counts);
  knn_query<<<grid, kQueryThreads, 0, s>>>(qs, Q, P, x0, z0, bin, nbx, nbz, r2, max_d, rings, xz, sorted_id,
                                          bin_start, out, cnt);
  return (int)cudaGetLastError();
}
