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
// 2304 samples). (1) One thread per (unit, variant) reads its box and writes
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
constexpr int kSmemBytes = 48 * 1024;

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
  if (per_unit > kSmemBytes) return (int)cudaErrorInvalidValue;  // one unit must fit
  int U = kSamplesPerBlock / S;
  U = U < 1 ? 1 : (U > kMaxUnits ? kMaxUnits : U);
  if (U * per_unit > kSmemBytes) U = kSmemBytes / per_unit;
  const unsigned blocks = (unsigned)((units + U - 1) / U);
  const size_t smem = (size_t)U * per_unit;
  if (C == 8 && spt::aligned(img, 16) && spt::aligned(out, 16))
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
// (b, p) adds wy_j * (wx_l * g[b, p, v, i, k, c]) to window cell (j, l) of
// the unit's window at (y0, x0), for the two taps j, l of each axis whose tent
// weight is non-zero; neighbouring units' windows overlap. The box gradient
// is not computed (the RPN's anchor boxes take none).
//
// Design: a block takes U units (4 on the main path, as many as fit 48 KB).
// (1) the units' output gradients go to shared memory with 16-byte loads;
// (2) the forward's coordinates and window starts in shared memory; (3) each
// unit's py x px x C window gradient in f32 shared memory, zeroed; (4) a
// thread per unit sorts its sample rows (v, i) by their first y tap; then a
// thread per (unit, window row, 4 channels) walks the sample rows whose y
// taps include its row and adds their samples into its own row with 16-byte
// shared loads and stores. No two threads write one cell, so no shared
// atomics: a first version gave each sample a thread and 32 shared atomics,
// which the variants' common cells serialised (315-382 us a view on an
// NVIDIA H100 80GB HBM3 at 700 W, against 83-99 us for this design). (5)
// The block adds its windows' non-zero cells into an f32 [B, H, W, C]
// buffer (zeroed first) with global atomics, 16 bytes each where C = 8;
// (6) for a bf16 image one pass rounds the buffer once to bf16 (an f32
// image's gradient is the buffer itself). Sums meet by atomics, so their
// order varies from run to run (f32 rounding). The reference sums a bf16
// map's gradient in bf16 (`_acc_dtype`, crop_resize.py:117-129); this
// kernel sums in f32 and rounds once.
//
// Bound on an H100: bytes. At the main path's shapes (4096 units of V = 32,
// 3 x 3 samples, C = 8 bf16 a view) a call reads 18.9 MB of output gradient
// and writes the [B, H, W, C] image gradient once.

// dst[0..N) += wy * (wx * g[0..N)), one vector load and store of N floats.
template <int N>
__device__ __forceinline__ void add_scaled(float* dst, float wy, float wx, const float (&g)[N]) {
  float a[N];
  spt::load_f32<float, N>(dst, a);
#pragma unroll
  for (int n = 0; n < N; ++n) a[n] = a[n] + wy * (wx * g[n]);
  spt::store_from_f32<float, N>(dst, a);
}

// Shared memory of C-bwd for U units: the f32 windows, the units' output
// gradients, then coordinates, starts and the row sort; each part from a
// 16-byte boundary.
struct BwdSmem {
  int grads, coords, total;
};
__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ __forceinline__ BwdSmem bwd_smem(int U, int py, int px, int C, int V, int CH,
                                                     int CW, int t_size) {
  BwdSmem m;
  m.grads = round16(U * py * px * C * (int)sizeof(float));
  m.coords = m.grads + round16(U * V * CH * CW * C * t_size);
  m.total = m.coords + (int)sizeof(float) * U * V * (CH + CW) +
            (int)sizeof(int) * U * (2 + V * CH + py + 1);
  return m;
}

template <typename T, int CV>
__global__ void __launch_bounds__(kThreads)
group_crop_bwd(const T* __restrict__ g, int H, int W, int c_rt, const float* __restrict__ boxes,
               int units, int P, int V, int CH, int CW, int patch, int U,
               float* __restrict__ acc) {
  const int C = CV > 0 ? CV : c_rt;
  const int py = min(patch, H), px = min(patch, W);
  const int win = py * px * C;
  const int S = V * CH * CW;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem sm = bwd_smem(U, py, px, C, V, CH, CW, (int)sizeof(T));
  float* windows = reinterpret_cast<float*>(smem);                // [U, py, px, C]
  T* gst = reinterpret_cast<T*>(smem + sm.grads);                 // [U, S, C]
  float* ys = reinterpret_cast<float*>(smem + sm.coords);          // [U, V, CH]
  float* xs = ys + U * V * CH;                                     // [U, V, CW]
  int* starts = reinterpret_cast<int*>(xs + U * V * CW);           // [U, 2]
  int* by_row = starts + 2 * U;                                    // [U, V * CH]
  int* row_off = by_row + U * V * CH;                              // [U, py + 1]

  const int unit0 = blockIdx.x * U;
  const int nu = min(U, units - unit0);

  // the units' gradients to shared memory: 16-byte loads where C = 8
  const T* g0 = g + (size_t)unit0 * S * C;
  if constexpr (CV > 0) {
    constexpr int kPer = 16 / (int)sizeof(T);
    for (int e = threadIdx.x; e < nu * S * CV / kPer; e += blockDim.x)
      reinterpret_cast<uint4*>(gst)[e] = reinterpret_cast<const uint4*>(g0)[e];
  } else {
    for (int e = threadIdx.x; e < nu * S * C; e += blockDim.x) gst[e] = g0[e];
  }
  for (int t = threadIdx.x; t < nu * V; t += blockDim.x) {
    const float* q = boxes + ((size_t)unit0 * V + t) * 4;
    sample_coords(q[0], q[2], CH, H, ys + t * CH);
    sample_coords(q[1], q[3], CW, W, xs + t * CW);
  }
  for (int e = threadIdx.x; e < nu * win; e += blockDim.x) windows[e] = 0.0f;
  for (int e = threadIdx.x; e < nu * (py + 1); e += blockDim.x) row_off[e] = 0;
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
    const int y0 = starts[2 * u] = min(max((int)floorf(y_mid - half), 0), max(H - patch, 0));
    starts[2 * u + 1] = min(max((int)floorf(x_mid - half), 0), max(W - patch, 0));
    // the unit's sample rows (v, i) sorted by their first y tap j0 (a counting
    // sort, stable in (v, i) order): row_off[j] .. row_off[j + 1] of by_row
    int* off = row_off + u * (py + 1);
    int* order = by_row + u * V * CH;
    const auto j0_of = [&](int vi) {
      return min((int)floorf(fminf(fmaxf(yu[vi] - (float)y0, 0.0f), (float)py - 1.0f)), py - 1);
    };
    for (int vi = 0; vi < V * CH; ++vi) ++off[1 + j0_of(vi)];
    for (int j = 1; j <= py; ++j) off[j] += off[j - 1];
    for (int vi = 0; vi < V * CH; ++vi) order[off[j0_of(vi)]++] = vi;
    for (int j = py; j > 0; --j) off[j] = off[j - 1];
    off[0] = 0;
  }
  __syncthreads();

  // each thread owns one window row j and W channels of a unit and sums
  // into that row the samples whose y taps include j: the rows (v, i) with
  // j0 = j and with j0 = j - 1. No two threads add into one cell: no atomics.
  constexpr int Wc = CV > 0 && CV % 4 == 0 ? 4 : 1;  // 16-byte row updates where C = 8
  const int groups = C / Wc;
  const int y_items = py * groups;
  for (int t = threadIdx.x; t < nu * y_items; t += blockDim.x) {
    const int u = t / y_items;
    const int j = (t - u * y_items) / groups;
    const int c = (t - u * y_items - j * groups) * Wc;
    const float y0 = (float)starts[2 * u], x0 = (float)starts[2 * u + 1];
    const float* yu = ys + u * V * CH;
    const float* xu = xs + u * V * CW;
    const T* gu = gst + (size_t)u * S * C + c;
    const int* order = by_row + u * V * CH;
    const int* off = row_off + u * (py + 1);
    float* row = windows + (size_t)u * win + j * px * C + c;
    for (int q = off[max(j - 1, 0)]; q < off[j + 1]; ++q) {
      const int vi = order[q];  // v * CH + i
      const float ry = fminf(fmaxf(yu[vi] - y0, 0.0f), (float)py - 1.0f);
      // the tap j of this row: tent(ry - j) is its weight whether j is the
      // row's j0 or j0 + 1 (0 at j0 + 1 where j0 is the last row)
      const float wy = tent(ry - (float)j);
      if (wy == 0.0f) continue;
      const float* xv = xu + (vi / CH) * CW;
      for (int k = 0; k < CW; ++k) {
        const float rx = fminf(fmaxf(xv[k] - x0, 0.0f), (float)px - 1.0f);
        const int l0 = min((int)floorf(rx), px - 1);
        const int l1 = min(l0 + 1, px - 1);
        float gv[Wc];
        spt::load_f32<T, Wc>(gu + (size_t)(vi * CW + k) * C, gv);
        add_scaled<Wc>(row + l0 * C, wy, tent(rx - (float)l0), gv);
        if (l1 > l0) add_scaled<Wc>(row + l1 * C, wy, tent(rx - (float)l1), gv);
      }
    }
  }
  __syncthreads();

  const int row_len = px * C;
  if constexpr (CV > 0 && CV % 4 == 0) {
    // 16-byte vector reductions (sm_90): a quarter of the global atomics
    const int win4 = win / 4, row4 = row_len / 4;
    for (int e = threadIdx.x; e < nu * win4; e += blockDim.x) {
      const float4 val = reinterpret_cast<const float4*>(windows)[e];
      if (val.x == 0.0f && val.y == 0.0f && val.z == 0.0f && val.w == 0.0f) continue;
      const int u = e / win4;
      const int rem = e - u * win4;
      const int r = rem / row4;
      const int b = (unit0 + u) / P;
      float* row = acc + (((size_t)b * H + starts[2 * u] + r) * W + starts[2 * u + 1]) * CV;
      atomicAdd(reinterpret_cast<float4*>(row) + (rem - r * row4), val);
    }
  } else {
    for (int e = threadIdx.x; e < nu * win; e += blockDim.x) {
      const float val = windows[e];
      if (val == 0.0f) continue;
      const int u = e / win;
      const int rem = e - u * win;
      const int r = rem / row_len;
      const int b = (unit0 + u) / P;
      atomicAdd(acc + ((size_t)b * H + starts[2 * u] + r) * W * C + (size_t)starts[2 * u + 1] * C +
                    (rem - r * row_len),
                val);
    }
  }
}

__global__ void round_to_bf16(const float* __restrict__ acc, long long n,
                              __nv_bfloat16* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16_rn(acc[i]);
}

template <typename T>
int launch_bwd(const void* g_v, int B, int H, int W, int C, const float* boxes, int P, int V,
               int CH, int CW, int patch, float* acc, cudaStream_t stream) {
  const T* g = static_cast<const T*>(g_v);
  const int units = B * P;
  const int S = V * CH * CW;
  const int py = patch < H ? patch : H;
  const int px = patch < W ? patch : W;
  const int t_size = (int)sizeof(T);
  if (bwd_smem(1, py, px, C, V, CH, CW, t_size).total > kSmemBytes)
    return (int)cudaErrorInvalidValue;  // one unit must fit
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * (size_t)B * H * W * C, stream);
  if (err != cudaSuccess || units == 0 || S == 0) return (int)err;
  int U = kSamplesPerBlock / S;
  U = U < 1 ? 1 : (U > kMaxUnits ? kMaxUnits : U);
  while (U > 1 && bwd_smem(U, py, px, C, V, CH, CW, t_size).total > kSmemBytes) --U;
  const unsigned blocks = (unsigned)((units + U - 1) / U);
  const size_t smem = (size_t)bwd_smem(U, py, px, C, V, CH, CW, t_size).total;
  if (C == 8 && spt::aligned(g, 16))
    group_crop_bwd<T, 8><<<blocks, kThreads, smem, stream>>>(g, H, W, C, boxes, units, P, V, CH,
                                                             CW, patch, U, acc);
  else
    group_crop_bwd<T, 0><<<blocks, kThreads, smem, stream>>>(g, H, W, C, boxes, units, P, V, CH,
                                                             CW, patch, U, acc);
  return (int)cudaGetLastError();
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
// 1 = bfloat16); boxes as the forward's; acc: [B, H, W, C] f32 scratch, the
// gradient itself for float32; out: [B, H, W, C] bfloat16 for dtype 1 (the
// rounded acc), unused for float32.
extern "C" int group_crop_bwd_launch(const void* g, int dtype, int B, int H, int W, int C,
                                     const float* boxes, int P, int V, int CH, int CW, int patch,
                                     float* acc, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(g, B, H, W, C, boxes, P, V, CH, CW, patch, acc, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int rc = launch_bwd<__nv_bfloat16>(g, B, H, W, C, boxes, P, V, CH, CW, patch, acc, s);
  if (rc != 0) return rc;
  const long long n = (long long)B * H * W * C;
  if (n == 0) return 0;
  round_to_bf16<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      acc, n, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
