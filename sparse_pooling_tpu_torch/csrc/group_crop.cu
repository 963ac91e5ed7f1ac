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
// product).
//
// Bound: bytes. Each unit reads one py x px x C window and writes V*ch*cw*C
// outputs (the outputs dominate). Design: one block per unit; the block copies
// its window (contiguous px*C runs per row) into shared memory as f32 once,
// then every thread evaluates outputs from shared memory, writing coalesced.
#include "common.cuh"

namespace {

__device__ __forceinline__ float sample_coord(float a, float b, int i, int n, int dim) {
  float s;
  if (n > 1) {
    const float step = (b - a) / (float)(n - 1);
    s = a + (float)i * step;
  } else {
    s = 0.5f * (a + b);
  }
  return fminf(fmaxf(s, 0.0f), (float)dim - 1.0f);
}

__device__ __forceinline__ float tent(float d) { return fmaxf(0.0f, 1.0f - fabsf(d)); }

template <typename T>
__global__ void group_crop(const T* __restrict__ img, int H, int W, int C,
                           const float* __restrict__ boxes, int P, int V, int CH, int CW,
                           int patch, T* __restrict__ out) {
  extern __shared__ float window[];
  __shared__ int s_y0, s_x0;
  const int unit = blockIdx.x;
  const int b = unit / P;
  const float* bx = boxes + (long long)unit * V * 4;
  const int py = min(patch, H), px = min(patch, W);

  if (threadIdx.x == 0) {
    float sy = 0.0f, sx = 0.0f;
    for (int v = 0; v < V; ++v) {
      const float* q = bx + v * 4;
      sy = sy + (sample_coord(q[0], q[2], 0, CH, H) + sample_coord(q[0], q[2], CH - 1, CH, H));
      sx = sx + (sample_coord(q[1], q[3], 0, CW, W) + sample_coord(q[1], q[3], CW - 1, CW, W));
    }
    const float y_mid = 0.5f * (sy / (float)V);
    const float x_mid = 0.5f * (sx / (float)V);
    const float half = (float)(patch - 2) / 2.0f;
    s_y0 = min(max((int)floorf(y_mid - half), 0), max(H - patch, 0));
    s_x0 = min(max((int)floorf(x_mid - half), 0), max(W - patch, 0));
  }
  __syncthreads();
  const int y0 = s_y0, x0 = s_x0;

  const int row_len = px * C;
  for (int e = threadIdx.x; e < py * row_len; e += blockDim.x) {
    const int r = e / row_len;
    const int rem = e % row_len;
    window[e] = spt::to_f32(img[(((long long)b * H + y0 + r) * W + x0) * C + rem]);
  }
  __syncthreads();

  const int n_out = V * CH * CW * C;
  T* dst = out + (long long)unit * n_out;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const int c = o % C;
    const int k = (o / C) % CW;
    const int i = (o / (C * CW)) % CH;
    const int v = o / (C * CW * CH);
    const float* q = bx + v * 4;
    const float ry = fminf(fmaxf(sample_coord(q[0], q[2], i, CH, H) - (float)y0, 0.0f), (float)py - 1.0f);
    const float rx = fminf(fmaxf(sample_coord(q[1], q[3], k, CW, W) - (float)x0, 0.0f), (float)px - 1.0f);
    const int j0 = min((int)floorf(ry), py - 1);
    const int l0 = min((int)floorf(rx), px - 1);
    const int j1 = min(j0 + 1, py - 1);
    const int l1 = min(l0 + 1, px - 1);
    const float wy0 = tent(ry - (float)j0);
    const float wy1 = j1 > j0 ? tent(ry - (float)j1) : 0.0f;
    const float wx0 = tent(rx - (float)l0);
    const float wx1 = l1 > l0 ? tent(rx - (float)l1) : 0.0f;
    const float t0 = wy0 * window[(j0 * px + l0) * C + c] + wy1 * window[(j1 * px + l0) * C + c];
    const float t1 = wy0 * window[(j0 * px + l1) * C + c] + wy1 * window[(j1 * px + l1) * C + c];
    dst[o] = spt::from_f32<T>(wx0 * t0 + wx1 * t1);
  }
}

template <typename T>
int launch(const void* img, int B, int H, int W, int C, const float* boxes, int P, int V,
           int CH, int CW, int patch, void* out, cudaStream_t stream) {
  const int units = B * P;
  if (units == 0) return 0;
  const int py = patch < H ? patch : H;
  const int px = patch < W ? patch : W;
  const size_t smem = sizeof(float) * (size_t)py * px * C;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  group_crop<T><<<units, 256, smem, stream>>>(static_cast<const T*>(img), H, W, C, boxes, P, V,
                                              CH, CW, patch, static_cast<T*>(out));
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
