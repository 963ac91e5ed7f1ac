// Kernel C: group-shared window ROI crop (the RPN's crop in both views).
//
// Replaces the forward of sparse_pooling_tpu/ops/crop_resize.py
// `crop_and_resize_group_einsum_px` (:875; `_group_einsum_impl` :531-574,
// `_group_starts` :476-511), whose TPU kernel form is the probe
// tools/probe_pallas_roi.py `make_fused_kernel` (:121: row slab plus both tent
// contractions); the probes' `make_window_slice_kernel` (:60) and
// `make_rowslab_kernel` (:88) are its gather stage, done here by the block's
// window load. For unit (b, p) with V variant boxes [y1, x1, y2, x2] (pixels):
//
//   ys[v, i] = clip(y1 + i * (y2 - y1) / (ch - 1), 0, H - 1)  (ch == 1: centre)
//   y0       = clip(floor(0.5 * mean_v(ys[v, 0] + ys[v, ch-1]) - (patch-2)/2),
//                   0, max(H - patch, 0))                    (same for x)
//   rel_y    = clip(ys - y0, 0, py - 1),  py = min(patch, H)
//   out[b, p, v, i, k, c] = sum_j sum_l tent(rel_y - j) tent(rel_x - l)
//                           * img[b, y0 + j, x0 + l, c],   tent(d) = max(0, 1 - |d|)
//
// Only the two taps j = floor(rel), floor(rel) + 1 (inside the window) have
// non-zero tent weight, so each output sums four terms: the y contraction
// first, then x, as the reference's two products do. Accumulates in f32 and
// rounds once to the image dtype (the bf16 reference rounds after each
// product). The mean over v is a sum in v order, then a divide by V: a
// one-ulp change there can cross an integer, move the window and change the
// edge-clamped samples, so it keeps the order of the first version.
//
// Bound on an H100: bytes. At the main path's shapes (4096 units of V = 32,
// 3 x 3 samples, C = 8 bf16) a view writes 18.9 MB and reads 1-2 MB of
// windows: about 6.5 us at 3.35 TB/s. The first version ran one block per
// unit with its serial phases (thread 0 computing the start from 128 divides,
// div/mod per loaded element, one thread per output element redoing the
// coordinates and storing 2 bytes) and reached 4% of the bound.
//
// Design: a block of 256 threads takes U units (U = 8 on the main path, so
// 2304 samples) within 48 KB of shared memory; where one unit needs more (a
// wide f32 window), a block takes as many as fit in 227 KB, opened once per
// device. (1) One thread per (unit, variant) reads its box and writes
// the unit's ys and xs to shared memory, one divide per axis. (2) One thread
// per unit sums the midpoints in v order and writes the window start. (3) The
// windows go to shared memory in the image dtype with 16-byte cp.async copies
// (a window row is px * C contiguous values). (4) One thread per sample
// (v, i, k) holds all C channels: four vector loads from shared memory, the
// f32 tent sums, one 16-byte store for C = 8 bf16 (two for f32). C = 8 is a
// compile-time path; other C take a generic path with scalar loads and stores.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSamplesPerBlock = 2304;  // 8 units of 32 variants x 3 x 3
constexpr int kMaxUnits = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemBytes = 48 * 1024;     // a block's target: several blocks an SM
constexpr int kMaxSmem = 227 * 1024;      // dynamic shared memory a block may take

__device__ __forceinline__ float tent(float d) { return fmaxf(0.0f, 1.0f - fabsf(d)); }

// The n sample coordinates of one box side, clipped to [0, dim - 1], with the
// reference's f32 operations in its order (step first, then a + i * step).
__device__ __forceinline__ void sample_coords(float a, float b, int n, int dim, float* dst) {
  const float hi = (float)dim - 1.0f;
  if (n > 1) {
    const float step = (b - a) / (float)(n - 1);
    for (int i = 0; i < n; ++i) dst[i] = fminf(fmaxf(a + (float)i * step, 0.0f), hi);
  } else {
    dst[0] = fminf(fmaxf(0.5f * (a + b), 0.0f), hi);
  }
}

// Shared memory of one unit: its window (padded to 16 bytes), ys, xs, start.
template <typename T>
__host__ __device__ __forceinline__ int window_bytes(int py, int px, int C) {
  return (int)((py * px * C * sizeof(T) + 15) / 16 * 16);
}

template <typename T>
__host__ __forceinline__ int unit_smem(int py, int px, int C, int V, int CH, int CW) {
  return window_bytes<T>(py, px, C) + (int)sizeof(float) * V * (CH + CW) + 2 * (int)sizeof(int);
}

// CV: channels fixed at compile time (the vector path), or 0 for a runtime C.
template <typename T, int CV>
__global__ void __launch_bounds__(kThreads)
group_crop(const T* __restrict__ img, int H, int W, int c_rt, const float* __restrict__ boxes,
           int units, int P, int V, int CH, int CW, int patch, int U, T* __restrict__ out) {
  const int C = CV > 0 ? CV : c_rt;
  const int py = min(patch, H), px = min(patch, W);
  const int win_stride = window_bytes<T>(py, px, C) / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* windows = reinterpret_cast<T*>(smem);
  float* ys = reinterpret_cast<float*>(windows + (size_t)U * win_stride);  // [U, V, CH]
  float* xs = ys + U * V * CH;                                              // [U, V, CW]
  int* starts = reinterpret_cast<int*>(xs + U * V * CW);                    // [U, 2]

  const int unit0 = blockIdx.x * U;
  const int nu = min(U, units - unit0);

  for (int t = threadIdx.x; t < nu * V; t += blockDim.x) {
    const float* q = boxes + ((size_t)unit0 * V + t) * 4;
    sample_coords(q[0], q[2], CH, H, ys + t * CH);
    sample_coords(q[1], q[3], CW, W, xs + t * CW);
  }
  __syncthreads();

  for (int u = threadIdx.x; u < nu; u += blockDim.x) {
    const float* yu = ys + u * V * CH;
    const float* xu = xs + u * V * CW;
    float sy = 0.0f, sx = 0.0f;
    for (int v = 0; v < V; ++v) {
      sy = sy + (yu[v * CH] + yu[v * CH + CH - 1]);
      sx = sx + (xu[v * CW] + xu[v * CW + CW - 1]);
    }
    const float y_mid = 0.5f * (sy / (float)V);
    const float x_mid = 0.5f * (sx / (float)V);
    const float half = (float)(patch - 2) / 2.0f;
    starts[2 * u] = min(max((int)floorf(y_mid - half), 0), max(H - patch, 0));
    starts[2 * u + 1] = min(max((int)floorf(x_mid - half), 0), max(W - patch, 0));
  }
  __syncthreads();

  if constexpr (CV > 0) {
    constexpr int kPer = 16 / (int)sizeof(T);  // values per 16-byte copy
    const int row_chunks = px * CV / kPer;
    const int per_unit = py * row_chunks;
    for (int e = threadIdx.x; e < nu * per_unit; e += blockDim.x) {
      const int u = e / per_unit;
      const int rem = e - u * per_unit;
      const int r = rem / row_chunks;
      const int k = rem - r * row_chunks;
      const int b = (unit0 + u) / P;
      const T* src = img + (((size_t)b * H + starts[2 * u] + r) * W + starts[2 * u + 1]) * CV;
      __pipeline_memcpy_async(windows + (size_t)u * win_stride + (r * row_chunks + k) * kPer,
                              src + k * kPer, 16);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    const int row_len = px * C;
    const int win = py * row_len;
    for (int e = threadIdx.x; e < nu * win; e += blockDim.x) {
      const int u = e / win;
      const int rem = e - u * win;
      const int r = rem / row_len;
      const int b = (unit0 + u) / P;
      windows[(size_t)u * win_stride + rem] =
          img[((size_t)b * H + starts[2 * u] + r) * W * C + (size_t)starts[2 * u + 1] * C +
              (rem - r * row_len)];
    }
  }
  __syncthreads();

  const int S = V * CH * CW;
  for (int s = threadIdx.x; s < nu * S; s += blockDim.x) {
    const int u = s / S;
    const int rem = s - u * S;
    const int vi = rem / CW;  // v * CH + i
    const int k = rem - vi * CW;
    const int v = vi / CH;
    const float ry =
        fminf(fmaxf(ys[u * V * CH + vi] - (float)starts[2 * u], 0.0f), (float)py - 1.0f);
    const float rx = fminf(fmaxf(xs[(u * V + v) * CW + k] - (float)starts[2 * u + 1], 0.0f),
                           (float)px - 1.0f);
    const int j0 = min((int)floorf(ry), py - 1);
    const int l0 = min((int)floorf(rx), px - 1);
    const int j1 = min(j0 + 1, py - 1);
    const int l1 = min(l0 + 1, px - 1);
    const float wy0 = tent(ry - (float)j0);
    const float wy1 = j1 > j0 ? tent(ry - (float)j1) : 0.0f;
    const float wx0 = tent(rx - (float)l0);
    const float wx1 = l1 > l0 ? tent(rx - (float)l1) : 0.0f;
    const T* win = windows + (size_t)u * win_stride;
    T* dst = out + ((size_t)(unit0 + u) * S + rem) * C;
    if constexpr (CV > 0) {
      float a00[CV], a01[CV], a10[CV], a11[CV], o[CV];
      spt::load_f32<T, CV>(win + (j0 * px + l0) * CV, a00);
      spt::load_f32<T, CV>(win + (j0 * px + l1) * CV, a01);
      spt::load_f32<T, CV>(win + (j1 * px + l0) * CV, a10);
      spt::load_f32<T, CV>(win + (j1 * px + l1) * CV, a11);
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const float t0 = wy0 * a00[c] + wy1 * a10[c];
        const float t1 = wy0 * a01[c] + wy1 * a11[c];
        o[c] = wx0 * t0 + wx1 * t1;
      }
      spt::store_from_f32<T, CV>(dst, o);
    } else {
      for (int c = 0; c < C; ++c) {
        const float t0 = wy0 * spt::to_f32(win[(j0 * px + l0) * C + c]) +
                         wy1 * spt::to_f32(win[(j1 * px + l0) * C + c]);
        const float t1 = wy0 * spt::to_f32(win[(j0 * px + l1) * C + c]) +
                         wy1 * spt::to_f32(win[(j1 * px + l1) * C + c]);
        dst[c] = spt::from_f32<T>(wx0 * t0 + wx1 * t1);
      }
    }
  }
}

template <typename T>
int launch(const void* img_v, int B, int H, int W, int C, const float* boxes, int P, int V,
           int CH, int CW, int patch, void* out_v, cudaStream_t stream) {
  const T* img = static_cast<const T*>(img_v);
  T* out = static_cast<T*>(out_v);
  const int units = B * P;
  const int S = V * CH * CW;
  if (units == 0 || S == 0) return 0;
  const int py = patch < H ? patch : H;
  const int px = patch < W ? patch : W;
  const int per_unit = unit_smem<T>(py, px, C, V, CH, CW);
  if (per_unit > kMaxSmem) return (int)cudaErrorInvalidValue;  // one unit must fit
  int U = kSamplesPerBlock / S;
  U = U < 1 ? 1 : (U > kMaxUnits ? kMaxUnits : U);
  // U within 48 KB where a unit fits there, else as many as fit in 227 KB
  const int budget = per_unit > kSmemBytes ? kMaxSmem : kSmemBytes;
  if (U * per_unit > budget) U = budget / per_unit;
  const unsigned blocks = (unsigned)((units + U - 1) / U);
  const size_t smem = (size_t)U * per_unit;
  const bool vec = C == 8 && spt::aligned(img, 16) && spt::aligned(out, 16);
  if (smem > (size_t)kSmemBytes) {
    const cudaError_t err = vec ? spt::open_smem<group_crop<T, 8>>(kMaxSmem)
                                : spt::open_smem<group_crop<T, 0>>(kMaxSmem);
    if (err != cudaSuccess) return (int)err;
  }
  if (vec)
    group_crop<T, 8><<<blocks, kThreads, smem, stream>>>(img, H, W, C, boxes, units, P, V, CH,
                                                         CW, patch, U, out);
  else
    group_crop<T, 0><<<blocks, kThreads, smem, stream>>>(img, H, W, C, boxes, units, P, V, CH,
                                                         CW, patch, U, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- C-bwd
//
// The image gradient of the crop, the window transpose of the reference's
// `_group_feature_grad` (crop_resize.py:789-834): sample (v, i, k) of unit
// (b, p) adds wy_j * wx_l * g[b, p, v, i, k, c] to window cell (j, l) of the
// unit's window at (y0, x0), for the two taps j, l of each axis whose tent
// weight is non-zero; neighbouring units' windows overlap. The box gradient
// is not computed (the RPN's anchor boxes take none).
//
// Bound on an H100: bytes. At the main path's shapes (4096 units of V = 32,
// 3 x 3 samples, C = 8 bf16 a view) a call reads 18.9 MB of output gradient
// and writes the [B, H, W, C] image gradient once. The fixed point costs the
// max pass's read of the gradient and an int64 buffer twice the size of the
// f32 one it replaced.
//
// Design: the reference's two contractions, each with every thread of the
// block busy, and sums in a fixed point so that the result does not depend
// on the order of the atomics. (0) A first pass takes max |g| over the
// gradient (the fixed point's scale, below). A block of 256 threads takes
// U units: as many as the
// forward's sample budget allows within a quarter of an SM's shared memory
// (56 KB), so that four blocks share an SM; on the main path that is 2 units
// with their channels in two chunks of 4. (Where one unit needs more, the
// block takes up to 227 KB.) PERF.md section 6 has 8 units a block in
// 227 KB at the main path's shapes, slower than 2 in 56 KB.
// (1) The units' output gradients go to shared memory with 16-byte cp.async
//     copies while one thread per (unit, variant) writes the sample
//     coordinates.
// (2) A warp per unit: lane 0 sums the midpoints in v order and divides, as
//     the forward does (a one-ulp change there would move the window); the
//     lanes write each (v, k) column's x taps and weights, then sort the
//     unit's sample rows (v, i) by their first y tap j0 with a counting sort
//     that stays stable in (v, i) order (`__match_any_sync` ranks the lanes
//     of one pass that share a tap).
// (3) x first: a thread per (unit, sample row, channel group) sums its CW
//     columns' wx * g into its own row of g_t[u, row, l, c] (f32, rows in
//     sorted order), so no two threads write one value.
// (4) y next: a thread per (unit, run of sorted rows, window column l,
//     channel group) walks its run in tap order with the cells (j0, l) and
//     (j0 + 1, l) of the current tap in registers, so each g_t value is read
//     once, and adds each cell its rows are past into an int64 [B, H, W, C]
//     buffer (zeroed first) with a global atomic, as round(sum * 2^shift)
//     (`fixed_shift`: no sum can overflow). The runs split each unit's rows
//     so that the block's threads are all busy and each walks as many rows;
//     a cell that spans two runs meets its rest in the buffer.
// Where g_t of all C channels does not fit beside the gradients, (3) and (4)
// run once per chunk of channels. (5) One pass turns the fixed-point sums
// into the gradient's dtype. Each thread's f32 partial sums are taken in an
// order fixed by the inputs (the sorted rows), and integer addition is
// associative, so two launches on the same inputs give the same bits
// whatever order the atomics take. The reference sums a bf16 map's gradient
// in bf16 (`_acc_dtype`, crop_resize.py:117-129); this kernel sums the f32
// partials exactly (to 2^-40 of max |g| at the main path) and rounds once.
//
// What holds it back on an H100 is the two contractions, not the atomics:
// PERF.md section 6 has chip_smoke.py's phase split at the main path's
// shapes. Each of these made the contractions slower, not faster:
// reading only the window columns a row reaches, writing each g_t cell once
// from registers, and a thread per window cell walking the rows of its two
// taps (the first form of (4), which read each g_t value twice and gave the
// threads of a warp unequal walks); and contracting x inside (4) from the
// staged gradients, with no g_t at all.

constexpr int kBwdThreads = 256;

// The fixed point of C-bwd's sums: a value x is held as round(x * 2^shift)
// in an int64, with shift = 62 - kbits - e, where max |g| < 2^e and the
// samples of the call number at most 2^kbits. Each sample's tent weights
// over the window sum to at most 1, so a cell's sum in a channel is below
// max |g| * samples < 2^(e + kbits), and times 2^shift below 2^62: no sum or
// partial sum can overflow the int64. One unit of the fixed point is
// max |g| * 2^(kbits - 61) or less, 2^-40 of max |g| at the main path's
// 1.2M samples. Returns false where max |g| is not finite.
__device__ __forceinline__ bool fixed_shift(const unsigned* amax_bits, int kbits, int* shift) {
  const float amax = __uint_as_float(*amax_bits);
  if (!(amax <= 3.402823466e38f)) return false;
  int e = 0;
  frexpf(amax, &e);  // amax < 2^e (e = 0 for amax = 0)
  *shift = 62 - kbits - e;
  return true;
}

__device__ __forceinline__ unsigned long long to_fixed(float x, int shift) {
  // exact scaling (the result lies below 2^62), then one rounding to an
  // integer; two's complement makes the unsigned atomic add signed sums
  return (unsigned long long)__float2ll_rn(ldexpf(x, shift));
}
constexpr int kSmemTarget = 56 * 1024;  // four blocks an SM

// dst[0..N) += w * g[0..N), one vector load and store of N floats.
template <int N>
__device__ __forceinline__ void add_scaled(float* dst, float w, const float (&g)[N]) {
  float a[N];
  spt::load_f32<float, N>(dst, a);
#pragma unroll
  for (int n = 0; n < N; ++n) a[n] = a[n] + w * g[n];
  spt::store_from_f32<float, N>(dst, a);
}

// A column (v, k)'s x taps: l0 and, where l0 + 1 is inside the window, l0 + 1.
struct XTap {
  float w0, w1;
  int l0, two;
};
// A sorted sample row: the tent weights of its y taps j0, j0 + 1, j0 and
// the row's index r = v * CH + i.
struct YRow {
  float w0, w1;
  int j0, r;
};

// Shared memory of C-bwd for U units and a channel chunk of Cc; each part
// starts at a 16-byte boundary.
struct BwdSmem {
  int gt, ys, xs, taps, rows, off, starts, total;
};
__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ __forceinline__ BwdSmem bwd_smem(int U, int Cc, int py, int px, int C, int V,
                                                     int CH, int CW, int t_size) {
  const int R = V * CH;
  BwdSmem m;
  m.gt = round16(U * R * CW * C * t_size);  // the gradients come first
  m.ys = m.gt + round16(U * R * (px * Cc + (C % 4 == 0 ? 4 : 1)) * (int)sizeof(float));
  m.xs = m.ys + round16(U * R * (int)sizeof(float));
  m.taps = m.xs + round16(U * V * CW * (int)sizeof(float));
  m.rows = m.taps + round16(U * V * CW * (int)sizeof(XTap));
  m.off = m.rows + round16(U * R * (int)sizeof(YRow));
  m.starts = m.off + round16(U * (py + 1) * (int)sizeof(int));
  m.total = m.starts + round16(U * 2 * (int)sizeof(int));
  return m;
}

// stop (the phase split of chip_smoke.py): 0 runs every phase; 1 stops after
// the loads, the window starts and the sort; 2 also runs both contractions
// but adds nothing into acc.
template <typename T, int CV>
__global__ void __launch_bounds__(kBwdThreads, 4)
group_crop_bwd(const T* __restrict__ g, int H, int W, int c_rt, const float* __restrict__ boxes,
               int units, int P, int V, int CH, int CW, int patch, int U, int Cc, int stop,
               const unsigned* __restrict__ amax_bits, int kbits,
               unsigned long long* __restrict__ acc) {
  const int C = CV > 0 ? CV : c_rt;
  constexpr int Wc = CV > 0 && CV % 4 == 0 ? 4 : 1;  // channels a thread carries
  const int py = min(patch, H), px = min(patch, W);
  const int R = V * CH;
  const int S = R * CW;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem sm = bwd_smem(U, Cc, py, px, C, V, CH, CW, (int)sizeof(T));
  T* gst = reinterpret_cast<T*>(smem);                          // [U, S, C]
  float* gt = reinterpret_cast<float*>(smem + sm.gt);           // [U, R, gs]: px x Cc used
  float* ys = reinterpret_cast<float*>(smem + sm.ys);           // [U, V, CH]
  float* xs = reinterpret_cast<float*>(smem + sm.xs);           // [U, V, CW]
  XTap* taps = reinterpret_cast<XTap*>(smem + sm.taps);         // [U, V, CW]
  YRow* rows = reinterpret_cast<YRow*>(smem + sm.rows);         // [U, R], sorted by j0
  int* off = reinterpret_cast<int*>(smem + sm.off);             // [U, py + 1] sort counts
  int* starts = reinterpret_cast<int*>(smem + sm.starts);       // [U, 2]
  const int gs = px * Cc + Wc;  // a g_t row's stride, padded against bank conflicts

  const int unit0 = blockIdx.x * U;
  const int nu = min(U, units - unit0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // (1) gradients and coordinates
  const T* g0 = g + (size_t)unit0 * S * C;
  if constexpr (CV > 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
    for (int e = threadIdx.x; e < nu * S * CV / kPer; e += blockDim.x)
      __pipeline_memcpy_async(gst + e * kPer, g0 + e * kPer, 16);
    __pipeline_commit();
  } else {
    for (int e = threadIdx.x; e < nu * S * C; e += blockDim.x) gst[e] = g0[e];
  }
  for (int t = threadIdx.x; t < nu * V; t += blockDim.x) {
    const float* q = boxes + ((size_t)unit0 * V + t) * 4;
    sample_coords(q[0], q[2], CH, H, ys + t * CH);
    sample_coords(q[1], q[3], CW, W, xs + t * CW);
  }
  __syncthreads();

  // (2) a warp per unit: window start, x taps, rows sorted by j0
  for (int u = warp; u < nu; u += blockDim.x >> 5) {
    const float* yu = ys + u * R;
    const float* xu = xs + u * V * CW;
    int y0 = 0, x0 = 0;
    if (lane == 0) {
      float sy = 0.0f, sx = 0.0f;
      for (int v = 0; v < V; ++v) {
        sy = sy + (yu[v * CH] + yu[v * CH + CH - 1]);
        sx = sx + (xu[v * CW] + xu[v * CW + CW - 1]);
      }
      const float y_mid = 0.5f * (sy / (float)V);
      const float x_mid = 0.5f * (sx / (float)V);
      const float half = (float)(patch - 2) / 2.0f;
      y0 = min(max((int)floorf(y_mid - half), 0), max(H - patch, 0));
      x0 = min(max((int)floorf(x_mid - half), 0), max(W - patch, 0));
      starts[2 * u] = y0;
      starts[2 * u + 1] = x0;
    }
    y0 = __shfl_sync(kFull, y0, 0);
    x0 = __shfl_sync(kFull, x0, 0);
    for (int e = lane; e < V * CW; e += 32) {
      const float rx = fminf(fmaxf(xu[e] - (float)x0, 0.0f), (float)px - 1.0f);
      const int l0 = min((int)floorf(rx), px - 1);
      const int l1 = min(l0 + 1, px - 1);
      taps[u * V * CW + e] = {tent(rx - (float)l0), l1 > l0 ? tent(rx - (float)l1) : 0.0f, l0,
                              l1 > l0};
    }
    // counting sort of the R rows by j0, stable in (v, i) order: counts in
    // cnt[1 + j0]; an inclusive scan makes cnt[j] the first place of tap j;
    // then pass by pass each lane takes cnt[j0] plus its rank among the
    // pass's lanes of the same j0, and the lowest of them advances cnt[j0]
    int* cnt = off + u * (py + 1);
    for (int j = lane; j < py + 1; j += 32) cnt[j] = 0;
    __syncwarp();
    const auto y_of = [&](int r) {
      return fminf(fmaxf(yu[r] - (float)y0, 0.0f), (float)py - 1.0f);
    };
    for (int r = lane; r < R; r += 32) atomicAdd(cnt + 1 + min((int)floorf(y_of(r)), py - 1), 1);
    __syncwarp();
    int carry = 0;
    for (int base = 0; base < py + 1; base += 32) {
      const int j = base + lane;
      int v = j < py + 1 ? cnt[j] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, v, d);
        if (lane >= d) v += y;
      }
      if (j < py + 1) cnt[j] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
    __syncwarp();
    YRow* ru = rows + u * R;
    const unsigned below = (1u << lane) - 1;
    for (int base = 0; base < R; base += 32) {
      const int r = base + lane;
      const float ry = r < R ? y_of(r) : 0.0f;
      const int j0 = r < R ? min((int)floorf(ry), py - 1) : -1 - lane;  // no match past R
      const unsigned peers = __match_any_sync(kFull, j0);
      const int at = r < R ? cnt[j0] + __popc(peers & below) : 0;
      __syncwarp();
      if (r < R) {
        if ((peers & below) == 0) cnt[j0] += __popc(peers);
        ru[at] = {tent(ry - (float)j0), tent(ry - (float)(j0 + 1)), j0, r};
      }
      __syncwarp();
    }
  }
  if constexpr (CV > 0) __pipeline_wait_prior(0);
  __syncthreads();
  if (stop == 1) return;
  int shift;
  if (!fixed_shift(amax_bits, kbits, &shift)) return;  // the finishing pass writes NaN

  for (int c0 = 0; c0 < C; c0 += Cc) {
    const int cn = min(Cc, C - c0);
    const int groups = cn / Wc;
    // (3) x first: g_t[u, place, l, :] = sum_k wx * g over the row's columns
    for (int e = threadIdx.x; e < nu * R * groups; e += blockDim.x) {
      const int u = e / (R * groups);
      const int rem = e - u * R * groups;
      const int q = rem / groups;  // sorted place
      const int c = (rem - q * groups) * Wc;
      const int r = rows[u * R + q].r;
      float* dst = gt + (size_t)(u * R + q) * gs + c;
      const float zero[Wc] = {};
      for (int l = 0; l < px; ++l) spt::store_from_f32<float, Wc>(dst + l * Cc, zero);
      const XTap* tv = taps + (u * V + r / CH) * CW;
      const T* gr = gst + ((size_t)u * S + r * CW) * C + c0 + c;
      for (int k = 0; k < CW; ++k) {
        const XTap tp = tv[k];
        float gv[Wc];
        spt::load_f32<T, Wc>(gr + k * C, gv);
        add_scaled<Wc>(dst + tp.l0 * Cc, tp.w0, gv);
        if (tp.two) add_scaled<Wc>(dst + (tp.l0 + 1) * Cc, tp.w1, gv);
      }
    }
    __syncthreads();
    // (4) y next: a thread per (unit, run of sorted rows, window column l,
    // channel group) walks its rows in tap order, holding cells (j, l) and
    // (j + 1, l) of the current tap j, and adds a cell into acc once its rows
    // are past; a cell that runs on in the next run meets its rest there by
    // the atomics. The runs split the rows so that the block's threads are
    // busy, and every thread walks as many rows.
    const int cols = nu * px * groups;
    const int runs = max(1, (int)blockDim.x / cols);
    const int per = (R + runs - 1) / runs;
    for (int e = threadIdx.x; e < cols * runs; e += blockDim.x) {
      const int u = e / (runs * px * groups);
      int rem = e - u * runs * px * groups;
      const int run = rem / (px * groups);
      rem -= run * px * groups;
      const int l = rem / groups;
      const int c = (rem - l * groups) * Wc;
      const int q0 = run * per, q1 = min(q0 + per, R);
      if (q0 >= q1) continue;
      const YRow* ru = rows + u * R;
      const float* src = gt + (size_t)u * R * gs + l * Cc + c;
      const int b = (unit0 + u) / P;
      unsigned long long* col =
          acc + (((size_t)b * H + starts[2 * u]) * W + starts[2 * u + 1] + l) * C + c0 + c;
      const auto add_cell = [&](int j, const float (&a)[Wc]) {
        bool any = false;
#pragma unroll
        for (int n = 0; n < Wc; ++n) any |= a[n] != 0.0f;
        if (!any) return;
        unsigned long long* cell = col + (size_t)j * W * C;
        if (stop == 2) {
          if (a[0] == -1.0e-38f) cell[0] = __float_as_uint(a[Wc - 1]);  // keeps the sums live, never true in practice
          return;
        }
#pragma unroll
        for (int n = 0; n < Wc; ++n) atomicAdd(cell + n, to_fixed(a[n], shift));
      };
      float a0[Wc] = {}, a1[Wc] = {};  // cells (cur, l) and (cur + 1, l)
      int cur = ru[q0].j0;
      for (int q = q0; q < q1; ++q) {
        const YRow yr = ru[q];
        if (yr.j0 != cur) {  // the rows are past cell (cur, l)
          add_cell(cur, a0);
          if (yr.j0 != cur + 1) add_cell(cur + 1, a1);
#pragma unroll
          for (int n = 0; n < Wc; ++n) {
            a0[n] = yr.j0 == cur + 1 ? a1[n] : 0.0f;
            a1[n] = 0.0f;
          }
          cur = yr.j0;
        }
        float t[Wc];
        spt::load_f32<float, Wc>(src + (size_t)q * gs, t);
#pragma unroll
        for (int n = 0; n < Wc; ++n) {
          a0[n] = a0[n] + yr.w0 * t[n];
          a1[n] = a1[n] + yr.w1 * t[n];
        }
      }
      add_cell(cur, a0);
      if (cur + 1 < py) add_cell(cur + 1, a1);
    }
    __syncthreads();
  }
}

// max |g| over the gradient, as the bits of a non-negative float (their
// order as unsigned ints is the floats' order; a NaN's bits exceed inf's),
// combined by atomicMax into *bits (zeroed first)
template <typename T>
__global__ void amax_abs(const T* __restrict__ g, long long n, unsigned* __restrict__ bits) {
  constexpr int kPer = 16 / (int)sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long nv = spt::aligned(g, 16) ? n / kPer : 0;
  unsigned m = 0;
  for (long long i = t; i < nv; i += stride) {
    float v[kPer];
    spt::load_f32<T, kPer>(g + i * kPer, v);
#pragma unroll
    for (int k = 0; k < kPer; ++k) m = max(m, __float_as_uint(fabsf(v[k])));
  }
  for (long long i = nv * kPer + t; i < n; i += stride)
    m = max(m, __float_as_uint(fabsf(spt::to_f32(g[i]))));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) m = max(m, __shfl_xor_sync(kFull, m, d));
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(bits, m);
}

// The fixed-point sums back to the gradient's dtype: one int64 to double
// conversion and an exact scaling, then one rounding to T. NaN everywhere
// where the gradient held a non-finite value.
template <typename T>
__global__ void finish_fixed(const unsigned long long* __restrict__ acc, long long n,
                             const unsigned* __restrict__ amax_bits, int kbits,
                             T* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int shift;
  const float v = fixed_shift(amax_bits, kbits, &shift)
                      ? (float)ldexp((double)(long long)acc[i], -shift)
                      : __int_as_float(0x7fc00000);
  out[i] = spt::from_f32<T>(v);
}

template <typename T>
cudaError_t launch_bwd_main(const T* g, int B, int H, int W, int C, const float* boxes, int P,
                            int V, int CH, int CW, int patch, int U, int Cc, int stop,
                            const unsigned* amax_bits, int kbits, unsigned long long* acc,
                            cudaStream_t stream) {
  const int units = B * P;
  const int py = patch < H ? patch : H;
  const int px = patch < W ? patch : W;
  const int t_size = (int)sizeof(T);
  const bool vec = C == 8 && spt::aligned(g, 16);
  const unsigned blocks = (unsigned)((units + U - 1) / U);
  const size_t smem = (size_t)bwd_smem(U, Cc, py, px, C, V, CH, CW, t_size).total;
  const cudaError_t err = vec ? spt::open_smem<group_crop_bwd<T, 8>>(kMaxSmem)
                              : spt::open_smem<group_crop_bwd<T, 0>>(kMaxSmem);
  if (err != cudaSuccess) return err;
  if (vec)
    group_crop_bwd<T, 8><<<blocks, kBwdThreads, smem, stream>>>(
        g, H, W, C, boxes, units, P, V, CH, CW, patch, U, Cc, stop, amax_bits, kbits, acc);
  else
    group_crop_bwd<T, 0><<<blocks, kBwdThreads, smem, stream>>>(
        g, H, W, C, boxes, units, P, V, CH, CW, patch, U, Cc, stop, amax_bits, kbits, acc);
  return cudaGetLastError();
}

// stop: the phase split's cut (0: none; see group_crop_bwd).
template <typename T>
int launch_bwd(const void* g_v, int B, int H, int W, int C, const float* boxes, int P, int V,
               int CH, int CW, int patch, unsigned long long* acc, void* out_v, int stop,
               cudaStream_t stream) {
  const T* g = static_cast<const T*>(g_v);
  T* out = static_cast<T*>(out_v);
  const int units = B * P;
  const int S = V * CH * CW;
  const int py = patch < H ? patch : H;
  const int px = patch < W ? patch : W;
  const int t_size = (int)sizeof(T);
  const bool vec = C == 8 && spt::aligned(g, 16);
  const int Wc = vec ? 4 : 1;
  int U0 = S > 0 ? kSamplesPerBlock / S : 1;
  U0 = U0 < 1 ? 1 : (U0 > kMaxUnits ? kMaxUnits : U0);
  // U from the forward's sample budget: the most units, then the widest
  // channel chunk, within a quarter of the SM's shared memory (four blocks
  // an SM); else, within all of a block's, the largest U * Cc (the larger U
  // on a tie). Refused where one unit with one channel group exceeds it.
  int U = 0, Cc = 0;
  for (int u = U0; u >= 1 && U == 0; --u)
    for (int cc = C / Wc * Wc; cc >= Wc && U == 0; cc -= Wc)
      if (bwd_smem(u, cc, py, px, C, V, CH, CW, t_size).total <= kSmemTarget) U = u, Cc = cc;
  if (U == 0) {
    for (int u = U0; u >= 1 && Cc < C; --u) {
      for (int cc = C / Wc * Wc; cc >= Wc; cc -= Wc) {
        if (bwd_smem(u, cc, py, px, C, V, CH, CW, t_size).total > kMaxSmem) continue;
        if ((long long)u * cc > (long long)U * Cc) U = u, Cc = cc;
        break;
      }
    }
  }
  if (U == 0) return (int)cudaErrorInvalidValue;  // one unit must fit
  // the int64 sums, then max |g|'s bits in the word after them
  const long long n_out = (long long)B * H * W * C;
  unsigned* amax_bits = reinterpret_cast<unsigned*>(acc + n_out);
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * (n_out + 1), stream);
  if (err != cudaSuccess) return (int)err;
  const long long n_samples = (long long)units * S;
  int kbits = 0;
  while ((1LL << kbits) < n_samples) ++kbits;
  if (n_samples > 0) {
    const long long n_g = n_samples * C;
    const long long want = (n_g + 256LL * 8 - 1) / (256LL * 8);
    amax_abs<T><<<(unsigned)(want < 1056 ? want : 1056), 256, 0, stream>>>(g, n_g, amax_bits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = launch_bwd_main<T>(g, B, H, W, C, boxes, P, V, CH, CW, patch, U, Cc, stop, amax_bits,
                             kbits, acc, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_out > 0)
    finish_fixed<T><<<(unsigned)((n_out + 255) / 256), 256, 0, stream>>>(acc, n_out, amax_bits,
                                                                       kbits, out);
  return (int)cudaGetLastError();
}

int bwd_launch(const void* g, int dtype, int B, int H, int W, int C, const float* boxes, int P,
               int V, int CH, int CW, int patch, unsigned long long* acc, void* out, int stop,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, B, H, W, C, boxes, P, V, CH, CW, patch, acc, out, stop, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, B, H, W, C, boxes, P, V, CH, CW, patch, acc, out, stop, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (img and out share it). boxes [B, P, V, 4]
// f32 pixel boxes; out [B, P, V, CH, CW, C].
extern "C" int group_crop_launch(const void* img, int dtype, int B, int H, int W, int C,
                                 const float* boxes, int P, int V, int CH, int CW, int patch,
                                 void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(img, B, H, W, C, boxes, P, V, CH, CW, patch, out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(img, B, H, W, C, boxes, P, V, CH, CW, patch, out, s);
  return (int)cudaErrorInvalidValue;
}

// g: [B, P, V, CH, CW, C] gradient of the crop in dtype (0 = float32,
// 1 = bfloat16); boxes as the forward's; acc: int64 scratch of
// B * H * W * C + 1 values (the fixed-point sums and max |g|); out:
// [B, H, W, C] in dtype.
extern "C" int group_crop_bwd_launch(const void* g, int dtype, int B, int H, int W, int C,
                                     const float* boxes, int P, int V, int CH, int CW, int patch,
                                     unsigned long long* acc, void* out, void* stream) {
  return bwd_launch(g, dtype, B, H, W, C, boxes, P, V, CH, CW, patch, acc, out, 0, stream);
}

// group_crop_bwd_launch with the kernel cut short, for timing its phases:
// stop 1 ends after the loads, window starts and row sort, stop 2 after both
// contractions (nothing is added into acc; the output is then not the
// gradient).
extern "C" int group_crop_bwd_split_launch(const void* g, int dtype, int B, int H, int W, int C,
                                           const float* boxes, int P, int V, int CH, int CW,
                                           int patch, unsigned long long* acc, void* out,
                                           int stop,
                                           void* stream) {
  return bwd_launch(g, dtype, B, H, W, C, boxes, P, V, CH, CW, patch, acc, out, stop, stream);
}
