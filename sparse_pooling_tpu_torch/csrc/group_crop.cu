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
